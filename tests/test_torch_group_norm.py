"""GroupNorm's no-grad kernel entry (ops/group_norm.py) on the CPU.

models/layers.py ``group_norm`` routes each call: the frame-sharded branch,
K10's GroupNorm Function with MOTIONEDITOR_FUSED_GN on, else the two-launch
kernel for a tensor off the CPU through which autograd records no graph
(the meta device stands for the card here, with a stand-in kernel library
that records its calls and launches nothing), else the plain version. On
the CPU ``silu=True`` is the plain version and then ``F.silu``, bit for
bit, gradients included. The kernel's launch plan is walked here (every
row of every column group written once), its arguments checked against
the C side's rules, and its arithmetic emulated (fp64 sums, then the plain
version's fp32 steps) against the plain version at the tolerance the card
is held to: at most 1 bf16 ulp on 99.9% of elements, 2 anywhere
(chip_smoke.bf16_ulps), also on an input whose mean is 30x its spread.
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
    """The kernel library's ``me_group_norm``: records its arguments,
    returns ``code`` and launches nothing."""

    def __init__(self):
        self.args, self.code = [], 0

    def me_group_norm(self, *args):
        self.args.append(args)
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


@pytest.mark.parametrize("through", ["x", "weight", "bias"])
def test_a_recorded_gradient_keeps_the_plain_version(lib, through):
    x = torch.empty((1, 2, 8, 8, 64), device=META, dtype=BF16, requires_grad=through == "x")
    p = norm(64, META)
    getattr(p, through if through != "x" else "weight").requires_grad_(through != "x")
    y = group_norm(p, x, 32, 1e-5, silu=True)
    assert y.requires_grad and y.grad_fn is not None
    assert lib.args == [] and counts() == {}


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
    assert args[6:14] == (b, s, c, 32, 1e-5, 1, _build.DTYPE_CODES[BF16],
                          _build.DTYPE_CODES[BF16])
    assert args[14:19] == tuple(stats) and stats.vec == 8
    assert args[19:21] == tuple(apply_plan(b, s, c, BF16, gn_kernel.META_SMS))
    workspace = gn_kernel._workspaces[(None, 0)]
    assert args[4] == workspace.data_ptr()
    assert workspace.numel() >= 16 * b * c + 4 * stats.workspace_floats(b, c)


def test_a_failed_launch_raises(lib):
    lib.code = 1  # cudaErrorInvalidValue
    x = torch.empty((2, 300, 320), device=META, dtype=BF16)
    p = norm(320, META)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        gn_kernel.group_norm(x, p.weight, p.bias, 32, 1e-5)
    assert counts() == {}


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
