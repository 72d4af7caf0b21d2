"""GroupNorm's kernel entry (ops/group_norm.py) on the CPU.

models/layers.py ``group_norm`` routes each call: the frame-sharded branch,
K10's GroupNorm Function with MOTIONEDITOR_FUSED_GN on, else the two-launch
kernel for a tensor off the CPU (the meta device stands for the card here,
with a stand-in kernel library that records its calls and launches
nothing), through ``GroupNormKernelFn`` and its two-launch backward where
autograd records a gradient, else the plain version. On the CPU
``silu=True`` is the plain version and then ``F.silu``, bit for bit,
gradients included. The kernel's launch plan is walked here (every row of
every column group written once), its arguments checked against the C
side's rules, and its arithmetic emulated (fp64 sums, then the plain
version's fp32 steps) against the plain version at the tolerance the card
is held to: at most 1 bf16 ulp on 99.9% of elements, 2 anywhere
(chip_smoke.bf16_ulps), also on an input whose mean is 30x its spread. The
backward's arithmetic (fp64 per-channel sums of g = dy * silu'(z), the
groups' coefficients, dx in fp32) is emulated against autograd of the plain
version and F.silu.
"""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.models.layers import group_norm
from motioneditor_tpu_torch.models.vae import AutoencoderKL, vae_decode, vae_encode_moments
from motioneditor_tpu_torch.ops import gn_stats
from motioneditor_tpu_torch.ops import group_norm as gn_kernel
from motioneditor_tpu_torch.ops.group_norm import (
    APPLY_MAX_THREADS,
    APPLY_ROWS,
    apply_plan,
    group_norm_plain,
)

META, BF16 = torch.device("meta"), torch.bfloat16
SMS = 132


class RecordingLibrary:
    """The kernel library's ``me_group_norm`` and ``me_group_norm_bwd``:
    record their arguments, return ``code`` and launch nothing."""

    def __init__(self):
        self.args, self.bwd_args, self.code = [], [], 0

    def me_group_norm(self, *args):
        self.args.append(args)
        return self.code

    def me_group_norm_bwd(self, *args):
        self.bwd_args.append(args)
        return self.code


@pytest.fixture
def lib(monkeypatch):
    fake = RecordingLibrary()
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.delenv("MOTIONEDITOR_FUSED_GN", raising=False)
    _build.reset_launch_counts()
    yield fake
    _build.reset_launch_counts()


def norm(c, device, dtype=BF16, requires_grad=False):
    p = torch.nn.GroupNorm(32 if c % 32 == 0 else 4, c, device=device).to(dtype)
    return p.requires_grad_(requires_grad)


def counts():
    return {k: n for k, n in _build.launch_counts.items() if k.startswith("group_norm")}


# --- the route ---------------------------------------------------------------------------


@pytest.mark.parametrize("silu", [False, True])
def test_the_cpu_keeps_the_plain_version(lib, silu):
    x = torch.randn(1, 3, 4, 4, 64).to(BF16)
    p = norm(64, "cpu")
    got = group_norm(p, x, 32, 1e-5, silu=silu)
    want = group_norm_plain(x, p.weight, p.bias, 32, 1e-5)
    assert torch.equal(got, F.silu(want) if silu else want)
    assert lib.args == [] and counts() == {}


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 64, 64, 320), (8, 32, 32, 640), (2, 4, 2560)])
def test_meta_without_grad_takes_the_kernel(lib, shape, silu):
    x = torch.empty(shape, device=META, dtype=BF16)
    y = group_norm(norm(shape[-1], META), x, 32, 1e-5, silu=silu)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert len(lib.args) == 1
    assert counts() == {"group_norm": 1, **({"group_norm.silu": 1} if silu else {})}


def test_no_grad_takes_the_kernel_for_inputs_that_require_grad(lib):
    x = torch.empty((1, 2, 8, 8, 64), device=META, dtype=BF16, requires_grad=True)
    with torch.no_grad():
        group_norm(norm(64, META, requires_grad=True), x, 32, 1e-5, silu=True)
    assert counts() == {"group_norm": 1, "group_norm.silu": 1}


def _recorded(through, device, dtype=BF16, shape=(1, 2, 8, 8, 64)):
    """An input and a norm module through which autograd records a gradient
    by ``through``: "x", "weight" or "bias"."""
    x = torch.empty(shape, device=device, dtype=dtype) if device == META else torch.randn(
        shape).to(dtype)
    x.requires_grad_(through == "x")
    p = norm(shape[-1], device, dtype)
    if through != "x":
        getattr(p, through).requires_grad_()
    return x, p


@pytest.mark.parametrize("through", ["x", "weight", "bias"])
def test_a_recorded_gradient_takes_the_function(lib, through):
    x, p = _recorded(through, META)
    y = group_norm(p, x, 32, 1e-5, silu=True)
    assert type(y.grad_fn).__name__ == "GroupNormKernelFnBackward"
    assert len(lib.args) == 1 and lib.bwd_args == []
    assert counts() == {"group_norm": 1, "group_norm.silu": 1, "group_norm.grad": 1}
    stats = lib.args[0][4]
    assert stats is not None  # the forward keeps the groups' mean and rstd
    y.backward(torch.empty_like(y))
    assert counts() == {"group_norm": 1, "group_norm.silu": 1, "group_norm.grad": 1,
                        "group_norm.bwd": 1}
    (args,) = lib.bwd_args
    # dx, dw, db: a pointer for each gradient asked for, null for the rest
    assert [a is not None for a in args[5:8]] == [through == t for t in ("x", "weight", "bias")]


@pytest.mark.parametrize("through", ["x", "weight", "bias"])
def test_a_recorded_gradient_on_the_cpu_keeps_the_plain_version(lib, through):
    x, p = _recorded(through, "cpu")
    y = group_norm(p, x, 32, 1e-5, silu=True)
    assert y.grad_fn is not None and "GroupNormKernelFn" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert lib.args == [] and lib.bwd_args == [] and counts() == {}


def test_a_checkpointed_call_records_twice_and_runs_one_backward(lib):
    """Under non-reentrant checkpointing (models/unet.py ``checkpointed``)
    the forward runs in the pass and again in the recompute, each one
    counting ``group_norm.grad``; the backward runs once."""
    x, p = _recorded("x", META)
    y = torch.utils.checkpoint.checkpoint(lambda t: group_norm(p, t, 32, 1e-5, silu=True) * 2,
                                          x, use_reentrant=False)
    y.backward(torch.empty_like(y))
    assert counts() == {"group_norm": 2, "group_norm.silu": 2, "group_norm.grad": 2,
                        "group_norm.bwd": 1}


def test_the_knob_routes_to_the_group_norm_function(lib, monkeypatch):
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
    calls = []
    monkeypatch.setattr(gn_stats, "group_norm_fused",
                        lambda p, x, g, eps, reduce=None: calls.append(x.shape) or x * 1)
    x = torch.empty((1, 2, 8, 8, 64), device=META, dtype=BF16)
    group_norm(norm(64, META), x, 32, 1e-5, silu=True)
    assert calls == [x.shape] and lib.args == [] and counts() == {}


@pytest.mark.parametrize("case", ["rows_of_8_bytes", "off_16_bytes", "float16", "groups"])
def test_what_the_16_byte_body_refuses_keeps_the_plain_version(lib, case):
    c, dtype, skip, groups = 64, BF16, 0, 32
    if case == "rows_of_8_bytes":
        c, groups = 36, 4  # 72-byte rows
    elif case == "off_16_bytes":
        skip = 4  # 8 bytes into the storage
    elif case == "float16":
        dtype = torch.float16
    else:
        groups = 24  # 64 channels do not split into 24 groups
    x = torch.empty((2 * 16 * c + skip,), device=META, dtype=dtype)[skip:].view(2, 16, c)
    p = norm(c, META, dtype)
    assert not gn_kernel.takes(x, p.weight, p.bias, groups)
    if case != "groups":
        group_norm(p, x, groups, 1e-5, silu=True)
        assert lib.args == [] and counts() == {}


def test_a_strided_input_is_copied_to_fresh_rows(lib):
    x = torch.empty((1, 2, 320, 8, 8), device=META, dtype=BF16).permute(0, 1, 3, 4, 2)
    assert not x.is_contiguous()
    y = group_norm(norm(320, META), x, 32, 1e-5, silu=True)
    assert y.is_contiguous() and counts() == {"group_norm": 1, "group_norm.silu": 1}


# --- silu=True on the CPU is the plain version then F.silu, bit for bit --------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 64), (6, 8, 8, 64), (1, 4, 4, 4, 128)],
                         ids=["pooled", "per_frame", "pooled_128"])
def test_silu_keyword_is_the_silu_of_the_norm(dtype, shape):
    gen = torch.Generator().manual_seed(0)
    x0 = (2 * torch.randn(shape, generator=gen) + 0.3).to(dtype)
    p = norm(shape[-1], "cpu", dtype, requires_grad=True)
    with torch.no_grad():
        p.weight.normal_(1.0, 0.3, generator=gen)
        p.bias.normal_(0.0, 0.2, generator=gen)
    dy = torch.randn(shape, generator=gen).to(dtype)
    results = []
    for fused in (True, False):
        x = x0.clone().requires_grad_()
        p.zero_grad()
        y = group_norm(p, x, 32, 1e-5, silu=True) if fused else F.silu(
            group_norm(p, x, 32, 1e-5))
        y.backward(dy)
        results.append((y.detach(), x.grad, p.weight.grad.clone(), p.bias.grad.clone()))
    for got, want in zip(*results):
        assert torch.equal(got, want)


# --- the launch ----------------------------------------------------------------------------


def test_the_call_passes_the_plans_and_the_workspace(lib):
    b, s, c = 2, 300, 320
    x = torch.empty((b, 3, 100, c), device=META, dtype=BF16)
    p = norm(c, META)
    gn_kernel.group_norm(x, p.weight, p.bias, 32, 1e-5, silu=True)
    (args,) = lib.args
    stats = gn_stats.pair_stats_plan(b, s, c, BF16, gn_kernel.META_SMS)
    assert args[7:15] == (b, s, c, 32, 1e-5, 1, _build.DTYPE_CODES[BF16],
                          _build.DTYPE_CODES[BF16])
    assert args[15:20] == tuple(stats) and stats.vec == 8
    assert args[20:22] == tuple(apply_plan(b, s, c, BF16, gn_kernel.META_SMS))
    workspace = gn_kernel._workspaces[(None, 0)]
    assert args[4] is None  # no gradient recorded: no statistics kept
    assert args[5] == workspace.data_ptr()
    assert workspace.numel() >= 16 * b * c + 4 * stats.workspace_floats(b, c)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_the_backward_passes_the_plans_and_the_workspace(lib, dtype, silu):
    b, s, c = 3, 300, 640
    x = torch.empty((b, 3, 100, c), device=META, dtype=dtype, requires_grad=True)
    p = norm(c, META, torch.float32, requires_grad=True)
    y = gn_kernel.group_norm(x, p.weight, p.bias, 32, 1e-5, silu=silu)
    y.backward(torch.empty_like(y))
    (args,) = lib.bwd_args
    assert args[10:17] == (b, s, c, 32, int(silu), _build.DTYPE_CODES[dtype],
                           _build.DTYPE_CODES[torch.float32])
    stats = gn_stats.pair_stats_plan(b, s, c, dtype, gn_kernel.META_SMS, same=False)
    assert args[17:22] == tuple(stats) and stats.vec == 16 // dtype.itemsize
    assert args[22:24] == tuple(apply_plan(b, s, c, dtype, gn_kernel.META_SMS))
    workspace = gn_kernel._workspaces[(None, 0)]
    assert args[8] == workspace.data_ptr()
    assert workspace.numel() >= 16 * b * c + 4 * stats.workspace_floats(b, c)
    assert x.grad.shape == x.shape and x.grad.dtype == dtype
    assert p.weight.grad.shape == (c,) and p.bias.grad.dtype == torch.float32


def test_a_failed_launch_raises(lib):
    lib.code = 1  # cudaErrorInvalidValue
    x = torch.empty((2, 300, 320), device=META, dtype=BF16)
    p = norm(320, META)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        gn_kernel.group_norm(x, p.weight, p.bias, 32, 1e-5)
    assert counts() == {}


def test_a_failed_backward_launch_raises(lib):
    x, p = _recorded("x", META)
    y = gn_kernel.group_norm(x, p.weight, p.bias, 32, 1e-5)
    lib.code = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="group_norm.bwd: CUDA launch failed with cudaError 1"):
        y.backward(torch.empty_like(y))
    assert "group_norm.bwd" not in counts()


def test_the_vae_launches_what_chip_smoke_expects(lib):
    """A VAE encode and decode at full width (the meta device): their
    GroupNorms (chip_smoke.VAE_*_GROUP_NORMS) take the kernel."""
    with META:
        vae = AutoencoderKL().to(BF16).eval()
    with torch.no_grad():
        vae_encode_moments(vae, torch.empty((2, 64, 64, 3), device=META, dtype=BF16))
        assert counts() == cs.VAE_ENCODE_GROUP_NORMS
        _build.reset_launch_counts()
        vae_decode(vae, torch.empty((2, 8, 8, 4), device=META, dtype=BF16))
    assert counts() == cs.VAE_DECODE_GROUP_NORMS


# --- the apply kernel's plan, walked ------------------------------------------------------


SD15_CASES = [(frames, shape) for frames in (8, 24)
              for shape in sorted(set(cs.unet_group_norm_shapes(frames=frames)))]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("frames,shape", SD15_CASES, ids=str)
def test_apply_plan_at_sd15_shapes(frames, shape, dtype):
    b, s, c = shape
    threads, ctas = apply_plan(b, s, c, dtype, SMS)
    cols = min(c * dtype.itemsize // 16, APPLY_MAX_THREADS)
    lanes = threads // cols
    assert threads % 32 == 0 and cols <= threads <= APPLY_MAX_THREADS and lanes >= 1
    assert 1 <= ctas <= -(-s // (lanes * APPLY_ROWS))
    assert b * ctas <= max(SMS * gn_kernel.APPLY_BLOCKS_PER_SM, b)  # one wave


@pytest.mark.parametrize("shape,want", [
    ((1, 98304, 320), (256, 264)), ((32, 4096, 320), (256, 8)), ((1, 6144, 2560), (320, 264)),
    ((4, 32768, 320), (256, 66)), ((1, 262144, 128), (256, 264)), ((24, 64, 1280), (160, 11)),
    ((300, 64, 320), (256, 1)),
])
def test_apply_plan_pinned(shape, want):
    assert apply_plan(*shape, BF16, SMS) == want


def walk(b, s, c, dtype, sms):
    """How often the apply kernel writes each (row, column group) of [B, S,
    C], emulating csrc/group_norm.cu's loops over its plan."""
    threads, ctas = apply_plan(b, s, c, dtype, sms)
    ncol = c * dtype.itemsize // 16
    cols = min(ncol, threads)
    lanes = threads // cols
    step = lanes * APPLY_ROWS
    hits = torch.zeros((b, s, ncol), dtype=torch.int32)
    for bi in range(b):
        for cta in range(ctas):
            for t in range(threads):
                col, lr = t % cols, t // cols
                if lr >= lanes:
                    continue
                for q in range(col, ncol, cols):
                    for r in range(cta * step + lr, s, ctas * step):
                        for u in range(APPLY_ROWS):
                            if r + u * lanes < s:
                                hits[bi, r + u * lanes, q] += 1
    return hits


@pytest.mark.parametrize("b,s,c,dtype,sms", [
    (1, 1000, 320, BF16, 4), (3, 37, 64, BF16, 2), (2, 300, 2560, torch.float32, 1),
    (1, 5, 128, BF16, 132), (2, 129, 4096, BF16, 1), (1, 64, 32, torch.float32, 3),
], ids=str)
def test_walk_writes_every_row_once(b, s, c, dtype, sms):
    assert (walk(b, s, c, dtype, sms) == 1).all()


# --- the kernel's arithmetic, emulated ------------------------------------------------------


def emulated(x, weight, bias, groups, eps, silu):
    """csrc/group_norm.cu's numbers: per-channel sums in fp64, the groups'
    mean and rstd from them in fp64 rounded to fp32, then per element the
    plain version's fp32 steps and roundings."""
    b, c = x.shape[0], x.shape[-1]
    xd = x.double().reshape(b, -1, c)
    n = xd.shape[1] * (c // groups)
    s1 = xd.sum(1).reshape(b, groups, -1).sum(-1)
    s2 = (xd * xd).sum(1).reshape(b, groups, -1).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    rstd = (1.0 / torch.sqrt(var + eps)).float().repeat_interleave(c // groups, -1)
    mean = mean.float().repeat_interleave(c // groups, -1)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    y = (x.float() - mean.view(shape)) * rstd.view(shape)
    y = (y * weight.float() + bias.float()).to(x.dtype)
    return F.silu(y) if silu else y


def assert_within_ulps(got, ref):
    ulps = cs.bf16_ulps(got, ref)
    assert ulps.max() <= 2 and (ulps <= 1).float().mean() >= 0.999, (
        ulps.max().item(), (ulps > 1).float().mean().item())


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("shape,shift", [((1, 4, 32, 32, 320), 0.0), ((8, 16, 16, 640), 0.0),
                                         ((1, 4, 16, 16, 320), 30.0), ((2, 64, 64, 128), 30.0)])
def test_emulated_kernel_matches_the_plain_version(shape, shift, dtype, silu):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) + shift).to(dtype)
    p = norm(shape[-1], "cpu", dtype)
    with torch.no_grad():
        p.weight.normal_(1.0, 0.3, generator=gen)
        p.bias.normal_(0.0, 0.2, generator=gen)
    want = group_norm_plain(x, p.weight, p.bias, 32, 1e-5)
    got = emulated(x, p.weight, p.bias, 32, 1e-5, silu)
    if silu:  # F.silu of a norm within the limit; 1 ulp of the norm below ~-3 is > 2 of the SiLU
        assert (cs.bf16_ulps(got, F.silu(want)) <= 1).float().mean() >= 0.999
    else:
        assert_within_ulps(got, want)


# --- the backward's arithmetic, emulated ----------------------------------------------------


def emulated_backward(x, weight, bias, dy, groups, eps, silu):
    """csrc/group_norm.cu's backward numbers: the forward's fp32 mean and
    rstd (from fp64 sums); g = dy * silu'(z), z recomputed at the forward's
    rounding points and rounded to x's dtype, g rounded to it as the plain
    version's gradient is (g = dy without the SiLU); per-channel fp64 sums
    S1 = sum g, S2 = sum g * x; the groups' a_g and b_g in fp64, rounded to
    fp32; dx = rstd * w * g - ((x - mean) * b_g + a_g) in fp32, rounded to
    x's dtype; dw = sum_b rstd * (S2 - mean * S1), db = sum_b S1."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xd = x.double().reshape(b, -1, c)
    n = xd.shape[1] * cpg
    s1 = xd.sum(1).reshape(b, groups, cpg).sum(-1)
    s2 = (xd * xd).sum(1).reshape(b, groups, cpg).sum(-1)
    mean64 = s1 / n
    var = torch.clamp(s2 / n - mean64 * mean64, min=0.0)
    mean, rstd = mean64.float(), (1.0 / torch.sqrt(var + eps)).float()  # [B, G]

    def per_channel(t):  # [B, G] -> [B, 1, C]
        return t.repeat_interleave(cpg, -1)[:, None]

    mc, rc = per_channel(mean), per_channel(rstd)
    xf, w = x.float().reshape(b, -1, c), weight.float()
    g = dy.float().reshape(b, -1, c)
    if silu:
        z = (((xf - mc) * rc) * w + bias.float()).to(x.dtype).float()
        sig = 1.0 / (1.0 + torch.exp(-z))
        g = (g * sig * (1.0 + z * (1.0 - sig))).to(x.dtype).float()
    gd = g.double()
    t1, t2 = gd.sum(1), (gd * xf.double()).sum(1)  # [B, C]
    md, rd = mc[:, 0].double(), rc[:, 0].double()
    a = (w.double() * t1).reshape(b, groups, cpg).sum(-1)
    q = (w.double() * (t2 - md * t1)).reshape(b, groups, cpg).sum(-1)
    r = rstd.double()
    bg, ag = per_channel((r ** 3 * q / n).float()), per_channel((r * a / n).float())
    dx = (rc * w * g - ((xf - mc) * bg + ag)).to(x.dtype).reshape(x.shape)
    dw = (rd * (t2 - md * t1)).sum(0).to(weight.dtype)
    return dx, dw, t1.sum(0).to(weight.dtype)


def assert_gradient_close(got, want):
    """fp32: within 1e-6 of max |want| (the emulation reads up to 2.7e-7
    off); bf16: at most 1 bf16 ulp on 99.9% of elements and 2 anywhere
    (the emulation reads 1 ulp on at most ~0.1% of dx and none of dw, db)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    else:
        assert_within_ulps(got, want)


@pytest.mark.parametrize("trained", [False, True], ids=["frozen", "trained"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("shape", [(1, 8, 16, 16, 320), (8, 16, 16, 640)],
                         ids=["pooled", "per_frame"])
def test_emulated_backward_matches_autograd_of_the_plain_version(shape, dtype, silu, trained):
    gen = torch.Generator().manual_seed(5)
    x = (2 * torch.randn(shape, generator=gen, dtype=torch.float64) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen).to(dtype)
    w = (1 + 0.3 * torch.randn(shape[-1], generator=gen)).to(dtype)
    b = (0.2 * torch.randn(shape[-1], generator=gen)).to(dtype)
    leaves = [x.clone().requires_grad_()] + [t.clone().requires_grad_(trained) for t in (w, b)]
    y = group_norm_plain(*leaves, 32, 1e-5)
    if silu:
        y = F.silu(y)
    want = torch.autograd.grad(y, [t for t in leaves if t.requires_grad], dy)
    got = emulated_backward(x, w, b, dy, 32, 1e-5, silu)
    assert len(want) == (3 if trained else 1)
    for g, t in zip(got, want):
        assert_gradient_close(g, t)
