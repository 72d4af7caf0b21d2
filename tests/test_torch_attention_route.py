"""The routing rule between the two bodies of K1 (video_flash_attention),
K2 (video_injection_attention), K8 (flash_attention), K9
(fused_injection_attention), K12 (video_flash_attention_kv), K13
(video_injection_attention_kv), K4 (video_flash_fwd_res), K5
(video_flash_bwd_dq) and K6 (video_flash_bwd_dkv): the dtype, the head
dim and the rows' alignment decide (for K9 also K/V broadcast over the
lead dims), and nothing else (no fallback after a failed launch); and the
launches of the TMA-staged temporal bodies, K3, K7 and K14 (on K3's body):
the entry, its (Fq, Fk, q_off) and tile, and a refusal of operands off a
16-byte boundary before any launch.

The rule is Python (ops/video_flash.py ``tensor_core_body`` and
``rows_aligned``, ops/video_flash_bwd.py ``fwd_res_tensor_core_body``,
``dq_tensor_core_body`` and ``dkv_tensor_core_body``), so it runs here on
the CPU. The
launch functions are driven with a stand-in for the kernel library that
records which C entry point they call; the kernels themselves are held to
their plain versions on the card (tests/test_torch_kernels_cuda.py).
"""

import math

import pytest
import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flash_attention as flash_mod
from motioneditor_tpu_torch.ops import video_flash as video_mod
from motioneditor_tpu_torch.ops.attention import split_heads
from motioneditor_tpu_torch.ops import temporal_flash as temporal_mod
from motioneditor_tpu_torch.ops import video_flash_bwd as bwd_mod
from motioneditor_tpu_torch.ops.video_flash import rows_aligned, tensor_core_body
from motioneditor_tpu_torch.ops.video_flash_bwd import (
    dkv_tensor_core_body,
    dq_tensor_core_body,
    fwd_res_tensor_core_body,
)


class RecordingLibrary:
    """Stands in for the kernel library: every ``me_*`` entry point records
    its name (``calls``) and arguments (``args``) and returns ``code`` (0:
    launched)."""

    def __init__(self, code: int = 0):
        self.calls = []
        self.args = []
        self.code = code

    def __getattr__(self, name):
        if not name.startswith("me_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.code

        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = RecordingLibrary()
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    _build.reset_launch_counts()
    yield fake
    _build.reset_launch_counts()


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 40, True, True),
    (torch.bfloat16, 80, True, True),
    (torch.bfloat16, 160, True, True),
    (torch.bfloat16, 8, True, True),
    (torch.bfloat16, 9, True, False),     # not a multiple of 8
    (torch.bfloat16, 36, True, False),
    (torch.bfloat16, 168, True, False),   # past the tensor-core body's 160
    (torch.bfloat16, 256, True, False),
    (torch.bfloat16, 40, False, False),   # a row off a 16-byte boundary
    (torch.float32, 40, True, False),     # fp32 keeps exact fp32 on CUDA cores
    (torch.float32, 80, True, False),
    (torch.float16, 40, True, False),
])
def test_tensor_core_body_rule(dtype, d, aligned, want):
    assert tensor_core_body(dtype, d, aligned) is want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 40, True, True),     # the 64x64 sites of SD-1.5
    (torch.bfloat16, 80, True, True),     # the 32x32 sites
    (torch.bfloat16, 8, True, True),
    (torch.bfloat16, 64, True, True),
    (torch.bfloat16, 88, True, False),    # past the dK / dV registers' 80
    (torch.bfloat16, 160, True, False),
    (torch.bfloat16, 36, True, False),    # not a multiple of 8
    (torch.bfloat16, 40, False, False),   # a row off a 16-byte boundary
    (torch.float32, 40, True, False),     # fp32 keeps exact fp32 on CUDA cores
    (torch.float32, 80, True, False),
    (torch.float16, 40, True, False),
])
def test_dkv_tensor_core_body_rule(dtype, d, aligned, want):
    assert dkv_tensor_core_body(dtype, d, aligned) is want


def test_rows_aligned_reads_base_and_strides():
    x = torch.zeros((2, 3, 64, 320), dtype=torch.bfloat16)
    assert rows_aligned(split_heads(x, 8).flatten(0, 1))          # d = 40: strides 40, 320
    assert not rows_aligned(split_heads(x[..., :36 * 8], 8).flatten(0, 1))  # d = 36
    flat = torch.zeros((2 * 64 * 320 + 4,), dtype=torch.bfloat16)
    off = flat[4:].view(2, 64, 8, 40).transpose(1, 2)             # base 8 bytes off
    assert not rows_aligned(off)
    bcast = torch.zeros((1, 8, 64, 40), dtype=torch.bfloat16).expand(6, 8, 64, 40)
    assert bcast.stride(0) == 0 and rows_aligned(bcast)           # K/V broadcast: stride 0
    x32 = torch.zeros((2, 3, 64, 40), dtype=torch.float32)        # 16 bytes = 4 floats
    assert rows_aligned(split_heads(x32[..., :32], 4).flatten(0, 1))      # d = 8: 32 bytes
    assert not rows_aligned(split_heads(x32[..., :36], 4).flatten(0, 1))  # d = 9: 36 bytes


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.bfloat16, 320, 8, "me_video_attention_tc"),
    (torch.bfloat16, 640, 8, "me_video_attention_tc"),
    (torch.bfloat16, 1280, 8, "me_video_attention_tc"),
    (torch.bfloat16, 32, 4, "me_video_attention_tc"),   # d = 8
    (torch.float32, 320, 8, "me_video_attention"),
    (torch.float32, 1280, 8, "me_video_attention"),
])
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame", "dense"])
def test_video_flash_launch_takes_the_routed_body(lib, dtype, c, heads, entry, mode):
    q = torch.zeros((2, 3, 50, c), dtype=dtype)
    out = video_mod._video_flash_kernel(q, q, q, mode, 0.1, heads)
    assert out.shape == q.shape and out.dtype == dtype
    assert lib.calls == [entry]
    tc = int(entry.endswith("_tc"))
    assert dict(_build.launch_counts) == {
        "video_flash_attention": 1, **({"video_flash_attention.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_video_flash_rejects_misaligned_rows(lib, dtype):
    """Both K1 bodies load 16-byte vectors: operands off a 16-byte boundary
    raise before any launch, whichever body the dtype would pick."""
    numel, skip = 2 * 3 * 50 * 320, 8 // torch.tensor([], dtype=dtype).element_size()
    off = torch.zeros((numel + skip,), dtype=dtype)[skip:].view(2, 3, 50, 320)  # 8 bytes off
    q = torch.zeros((2, 3, 50, 320), dtype=dtype)
    with pytest.raises(ValueError, match="16-byte boundary"):
        video_mod._video_flash_kernel(q, off, q, "motion_frame", 0.1, 8)
    assert lib.calls == [] and not _build.launch_counts


def _split_case(case):
    """(q, k, v) of one K8 routing case, CPU tensors."""
    if case == "packed_views":   # head-split views of packed [B, F, N, C]
        x = torch.zeros((2, 3, 64, 320), dtype=torch.bfloat16)
        return (split_heads(x, 8),) * 3
    if case == "offset_views":   # the same, 8 bytes off a 16-byte boundary
        flat = torch.zeros((2 * 3 * 64 * 320 + 4,), dtype=torch.bfloat16)
        return (split_heads(flat[4:].view(2, 3, 64, 320), 8),) * 3
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    d = {"d9": 9, "d200": 200, "d160": 160}.get(case, 40)
    q = torch.zeros((2, 3, 4, 100, d), dtype=dtype)
    kv_lead = (2, 1) if case == "broadcast" else (2, 3)
    k = torch.zeros((*kv_lead, 4, 150, d), dtype=dtype)
    return q, k, k


@pytest.mark.parametrize("case,tc", [
    ("plain", True), ("broadcast", True), ("packed_views", True), ("d160", True),
    ("fp32", False), ("d9", False), ("d200", False), ("offset_views", False),
])
def test_flash_attention_launch_takes_the_routed_body(lib, case, tc):
    q, k, v = _split_case(case)
    out = flash_mod.launch_split_attention("flash_attention", flash_mod._FLASH_CODE, q, k, v,
                                           0.1)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lib.calls == ["me_split_attention_tc" if tc else "me_split_attention"]
    assert dict(_build.launch_counts) == {
        "flash_attention": 1, **({"flash_attention.tc": 1} if tc else {})}


def _injection_case(case):
    """(q, k_src, v_src, mask, k_tgt, v_tgt) of one K9 routing case, CPU
    tensors: [B, F, H, N, d] with 3 frames, Ns = 2Nq source keys."""
    if case in ("packed_views", "offset_views"):
        # head-split views of packed [B, F, N, C] tensors, d = 40 (80-byte head
        # offsets); "offset_views" 8 bytes off a 16-byte boundary
        skip = 4 if case == "offset_views" else 0

        def packed(n):
            flat = torch.zeros((2 * 3 * n * 320 + skip,), dtype=torch.bfloat16)
            return split_heads(flat[skip:].view(2, 3, n, 320), 8)

        return packed(64), packed(128), packed(128), torch.zeros((3, 128)), packed(64), packed(64)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    d = {"d9": 9, "d200": 200, "d160": 160}.get(case, 40)
    q, kt = (torch.zeros((2, 3, 4, 100, d), dtype=dtype) for _ in range(2))
    src_lead = (1, 1) if case == "broadcast" else (2, 3)  # broadcast: G stride 0
    ks = torch.zeros((*src_lead, 4, 200, d), dtype=dtype)
    return q, ks, ks, torch.zeros((3, 200)), kt, kt


def _launch_injection(case):
    q, ks, vs, mask, kt, vt = _injection_case(case)
    out = flash_mod.launch_split_attention("fused_injection_attention",
                                           flash_mod._INJECTION_CODE, q, ks, vs, 0.1, kt, vt,
                                           mask, q.shape[1])
    assert out.shape == q.shape and out.dtype == q.dtype


@pytest.mark.parametrize("case", ["fp32", "d9", "d200", "offset_views", "broadcast"])
def test_injection_keeps_the_cuda_core_body(lib, case):
    """K9 (the split-head injection) keeps the CUDA-core body where K8's
    rule declines the tensor cores (fp32, d % 8 != 0, d > 160, a row off a
    16-byte boundary) and where a K/V view broadcasts over the lead dims (the
    injection instantiation reads K/V group g for query group g)."""
    _launch_injection(case)
    assert lib.calls == ["me_split_attention"]
    assert dict(_build.launch_counts) == {"fused_injection_attention": 1}


@pytest.mark.parametrize("case", ["plain", "packed_views", "d160"])
def test_injection_takes_the_tensor_core_body(lib, case):
    """K9 in bf16 with d % 8 == 0, d <= 160, aligned rows and unbroadcast
    K/V takes the injection instantiation of the tensor-core body through
    ``me_split_injection_tc``, with its 18 strides, and counts ``.tc``."""
    _launch_injection(case)
    assert lib.calls == ["me_split_injection_tc"]
    args = lib.args[0]
    g, h, nq, ns, nt, frames = args[8:14]
    assert (g, frames) == (6, 3) and ns == 2 * nq and nt == nq
    assert len(args[7]) == 18 and all(args[7][i] for i in (3, 6, 9, 12))
    assert dict(_build.launch_counts) == {"fused_injection_attention": 1,
                                          "fused_injection_attention.tc": 1}


def test_failed_split_injection_launch_raises_and_is_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _launch_injection("plain")
    assert lib.calls == ["me_split_injection_tc"]
    assert not _build.launch_counts


def test_a_failed_launch_raises_and_is_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    q = torch.zeros((2, 3, 50, 320), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        video_mod._video_flash_kernel(q, q, q, "motion_frame", 0.1, 8)
    qs = torch.zeros((2, 4, 100, 40), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        flash_mod.launch_split_attention("flash_attention", flash_mod._FLASH_CODE, qs, qs, qs,
                                         0.1)
    assert lib.calls == ["me_video_attention_tc", "me_split_attention_tc"]
    assert not _build.launch_counts


def _off(shape, dtype):
    """A contiguous tensor whose base is 8 bytes off a 16-byte boundary."""
    numel, skip = math.prod(shape), 8 // torch.tensor([], dtype=dtype).element_size()
    return torch.zeros((numel + skip,), dtype=dtype)[skip:].view(shape)


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.bfloat16, 320, 8, "me_video_attention_kv_tc"),
    (torch.bfloat16, 640, 8, "me_video_attention_kv_tc"),
    (torch.bfloat16, 1280, 8, "me_video_attention_kv_tc"),
    (torch.float32, 320, 8, "me_video_attention_kv"),
    (torch.float32, 640, 8, "me_video_attention_kv"),
])
@pytest.mark.parametrize("fk", ["one", "per_frame"])
def test_video_flash_kv_launch_takes_the_routed_body(lib, dtype, c, heads, entry, fk):
    """K12 over K/V [B, Fk, M, C] with Fk = 1 (the dense sharded site) or F."""
    q = torch.zeros((2, 3, 50, c), dtype=dtype)
    kv = torch.zeros((2, 1, 150, c) if fk == "one" else (2, 3, 100, c), dtype=dtype)
    out = video_mod._video_kv_kernel(q, kv, kv, None, None, None, 0.1, heads)
    assert out.shape == q.shape and out.dtype == dtype
    assert lib.calls == [entry]
    tc = int(entry.endswith("_tc"))
    assert dict(_build.launch_counts) == {
        "video_flash_attention_kv": 1, **({"video_flash_attention_kv.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_video_injection_kv_keeps_the_cuda_core_body(lib, dtype):
    """K13 (the explicit-K/V injection) keeps the CUDA-core body where the
    rule declines the tensor cores (fp32), and takes K12's rule otherwise:
    in bf16 at d = 40 its injection instantiation."""
    q = torch.zeros((2, 3, 50, 320), dtype=dtype)
    ks = torch.zeros((2, 3, 100, 320), dtype=dtype)
    video_mod._video_kv_kernel(q, ks, ks, q, q, torch.zeros((3, 100)), 0.1, 8)
    tc = dtype == torch.bfloat16
    assert lib.calls == ["me_video_injection_kv_tc" if tc else "me_video_attention_kv"]
    assert dict(_build.launch_counts) == {
        "video_injection_attention_kv": 1,
        **({"video_injection_attention_kv.tc": 1} if tc else {})}


INJECTION_ROUTES = [  # (dtype, c, heads, the tensor-core body?)
    (torch.bfloat16, 320, 8, True),    # d = 40: the 64x64 sites of SD-1.5
    (torch.bfloat16, 640, 8, True),    # d = 80: the 32x32 sites
    (torch.bfloat16, 1280, 8, True),   # d = 160
    (torch.bfloat16, 32, 4, True),     # d = 8
    (torch.float32, 320, 8, False),    # fp32 keeps exact fp32 on CUDA cores
    (torch.float32, 640, 8, False),
    (torch.float32, 1280, 8, False),
]


@pytest.mark.parametrize("dtype,c,heads,tc", INJECTION_ROUTES)
def test_video_injection_launch_takes_the_routed_body(lib, dtype, c, heads, tc):
    """K2: bf16 at d % 8 == 0, d <= 160 on the injection instantiation of
    the tensor-core body, fp32 on the CUDA-core body."""
    q = torch.zeros((2, 3, 50, c), dtype=dtype)
    out = video_mod._video_injection_kernel(q, q, q, q, q, torch.zeros((3, 50)), 0.1, heads)
    assert out.shape == q.shape and out.dtype == dtype
    assert lib.calls == ["me_video_injection_tc" if tc else "me_video_attention"]
    assert dict(_build.launch_counts) == {
        "video_injection_attention": 1, **({"video_injection_attention.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype,c,heads,tc", INJECTION_ROUTES)
@pytest.mark.parametrize("m", [100, 77])  # M = 2N (the halo-built [prev | cur]); ragged
def test_video_injection_kv_launch_takes_the_routed_body(lib, dtype, c, heads, tc, m):
    q = torch.zeros((2, 3, 50, c), dtype=dtype)
    ks = torch.zeros((2, 3, m, c), dtype=dtype)
    out = video_mod._video_kv_kernel(q, ks, ks, q, q, torch.zeros((3, m)), 0.1, heads)
    assert out.shape == q.shape and out.dtype == dtype
    assert lib.calls == ["me_video_injection_kv_tc" if tc else "me_video_attention_kv"]
    assert dict(_build.launch_counts) == {
        "video_injection_attention_kv": 1,
        **({"video_injection_attention_kv.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("operand", ["q_tgt", "k_src", "v_src", "k_tgt", "v_tgt"])
def test_video_injection_rejects_misaligned_rows(lib, dtype, operand):
    """K2 loads 16-byte vectors on both bodies: an operand off a 16-byte
    boundary raises before any launch (ROADMAP C2)."""
    shape = (2, 3, 50, 320)
    ops = {name: torch.zeros(shape, dtype=dtype)
           for name in ("q_tgt", "k_src", "v_src", "k_tgt", "v_tgt")}
    ops[operand] = _off(shape, dtype)
    with pytest.raises(ValueError, match="16-byte boundary"):
        video_mod._video_injection_kernel(*ops.values(), torch.zeros((3, 50)), 0.1, 8)
    assert lib.calls == [] and not _build.launch_counts


def test_failed_injection_launches_raise_and_are_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    q = torch.zeros((2, 3, 50, 320), dtype=torch.bfloat16)
    ks = torch.zeros((2, 3, 100, 320), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        video_mod._video_injection_kernel(q, q, q, q, q, torch.zeros((3, 50)), 0.1, 8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        video_mod._video_kv_kernel(q, ks, ks, q, q, torch.zeros((3, 100)), 0.1, 8)
    assert lib.calls == ["me_video_injection_tc", "me_video_injection_kv_tc"]
    assert not _build.launch_counts


@pytest.mark.parametrize("kernel", ["injection", "injection_kv"])
def test_injection_takes_the_plain_version_on_the_cpu(lib, kernel):
    """K2's and K13's CPU tensors run their plain versions and launch nothing."""
    gen = torch.Generator().manual_seed(0)
    m = 20 if kernel == "injection" else 40
    q, kt, vt = (torch.randn((1, 3, 20, 32), generator=gen) for _ in range(3))
    ks, vs = (torch.randn((1, 3, m, 32), generator=gen) for _ in range(2))
    mask = torch.rand((3, m), generator=gen)
    fn, plain = ((video_mod.video_injection_attention, video_mod.video_injection_attention_plain)
                 if kernel == "injection" else
                 (video_mod.video_injection_attention_kv,
                  video_mod.video_injection_attention_kv_plain))
    out = fn(q, ks, vs, kt, vt, mask, 0.25, 4)
    torch.testing.assert_close(out, plain(q, ks, vs, kt, vt, mask, 0.25, 4), atol=0, rtol=0)
    assert lib.calls == [] and not _build.launch_counts


def _dkv_args(dtype, c, heads, mode="motion_frame", b=2, f=3, n=50, q=None):
    q = torch.zeros((b, f, n, c), dtype=dtype) if q is None else q
    rows = torch.zeros((b, f, n, heads))
    return (q, q, q, rows, rows, q, mode, 0.1, heads)


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.bfloat16, 320, 8, "me_video_attention_bwd_dkv_tc"),   # d = 40
    (torch.bfloat16, 640, 8, "me_video_attention_bwd_dkv_tc"),   # d = 80
    (torch.bfloat16, 32, 4, "me_video_attention_bwd_dkv_tc"),    # d = 8
    (torch.bfloat16, 768, 8, "me_video_attention_bwd_dkv"),      # d = 96: past 80
    (torch.bfloat16, 1280, 8, "me_video_attention_bwd_dkv"),     # d = 160
    (torch.float32, 320, 8, "me_video_attention_bwd_dkv"),
    (torch.float32, 640, 8, "me_video_attention_bwd_dkv"),
])
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
def test_dkv_launch_takes_the_routed_body(lib, dtype, c, heads, entry, mode):
    dkp, dvp = bwd_mod.video_flash_bwd_dkv(*_dkv_args(dtype, c, heads, mode))
    slots = 1 if mode == "normal" else 2
    assert dkp.shape == dvp.shape == (2, 3, slots, 50, c) and dkp.dtype == torch.float32
    assert lib.calls == [entry]
    tc = int(entry.endswith("_tc"))
    assert dict(_build.launch_counts) == {
        "video_flash_bwd_dkv": 1, **({"video_flash_bwd_dkv.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["kv", "injection_kv", "dkv"])
def test_kv_and_dkv_reject_misaligned_rows(lib, dtype, kernel):
    """K12, K13 and K6 load 16-byte vectors on both bodies: an operand off
    a 16-byte boundary raises before any launch."""
    q = torch.zeros((2, 3, 50, 320), dtype=dtype)
    off = _off((2, 3, 50, 320), dtype)
    with pytest.raises(ValueError, match="16-byte boundary"):
        if kernel == "kv":
            video_mod._video_kv_kernel(q, off, q, None, None, None, 0.1, 8)
        elif kernel == "injection_kv":
            video_mod._video_kv_kernel(q, q, q, off, q, torch.zeros((3, 50)), 0.1, 8)
        else:
            bwd_mod.video_flash_bwd_dkv(*_dkv_args(dtype, 320, 8, q=off))
    assert lib.calls == [] and not _build.launch_counts


def test_failed_kv_and_dkv_launches_raise_and_are_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    q = torch.zeros((2, 3, 50, 320), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        video_mod._video_kv_kernel(q, q, q, None, None, None, 0.1, 8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        bwd_mod.video_flash_bwd_dkv(*_dkv_args(torch.bfloat16, 320, 8))
    assert lib.calls == ["me_video_attention_kv_tc", "me_video_attention_bwd_dkv_tc"]
    assert not _build.launch_counts


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 40, True, True),     # the 64x64 sites of SD-1.5
    (torch.bfloat16, 80, True, True),     # the 32x32 sites
    (torch.bfloat16, 160, True, True),    # K1's mainloop takes d <= 160
    (torch.bfloat16, 8, True, True),
    (torch.bfloat16, 168, True, False),   # past K1's 160
    (torch.bfloat16, 36, True, False),    # not a multiple of 8
    (torch.bfloat16, 40, False, False),   # a row off a 16-byte boundary
    (torch.float32, 40, True, False),     # fp32 keeps exact fp32 on CUDA cores
    (torch.float32, 80, True, False),
    (torch.float16, 40, True, False),
])
def test_fwd_res_tensor_core_body_rule(dtype, d, aligned, want):
    assert fwd_res_tensor_core_body(dtype, d, aligned) is want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 40, True, True),     # the 64x64 sites of SD-1.5
    (torch.bfloat16, 80, True, True),     # the 32x32 sites
    (torch.bfloat16, 8, True, True),
    (torch.bfloat16, 64, True, True),
    (torch.bfloat16, 88, True, False),    # past the dQ registers' 80
    (torch.bfloat16, 160, True, False),
    (torch.bfloat16, 36, True, False),    # not a multiple of 8
    (torch.bfloat16, 40, False, False),   # a row off a 16-byte boundary
    (torch.float32, 40, True, False),     # fp32 keeps exact fp32 on CUDA cores
    (torch.float32, 80, True, False),
    (torch.float16, 40, True, False),
])
def test_dq_tensor_core_body_rule(dtype, d, aligned, want):
    assert dq_tensor_core_body(dtype, d, aligned) is want


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.bfloat16, 320, 8, "me_video_attention_fwd_res_tc"),   # d = 40
    (torch.bfloat16, 640, 8, "me_video_attention_fwd_res_tc"),   # d = 80
    (torch.bfloat16, 1280, 8, "me_video_attention_fwd_res_tc"),  # d = 160
    (torch.bfloat16, 32, 4, "me_video_attention_fwd_res_tc"),    # d = 8
    (torch.float32, 320, 8, "me_video_attention_fwd_res"),
    (torch.float32, 640, 8, "me_video_attention_fwd_res"),
])
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
def test_fwd_res_launch_takes_the_routed_body(lib, dtype, c, heads, entry, mode):
    out, lse = bwd_mod._fwd_res_kernel(torch.zeros((2, 3, 50, c), dtype=dtype),
                                       *(torch.zeros((2, 3, 50, c), dtype=dtype),) * 2,
                                       mode, 0.1, heads)
    assert out.shape == (2, 3, 50, c) and out.dtype == dtype
    assert lse.shape == (2, 3, 50, heads) and lse.dtype == torch.float32
    assert lib.calls == [entry]
    tc = int(entry.endswith("_tc"))
    assert dict(_build.launch_counts) == {
        "video_flash_fwd_res": 1, **({"video_flash_fwd_res.tc": 1} if tc else {})}


def _dq_args(dtype, c, heads, mode="motion_frame", b=2, f=3, n=50, q=None):
    q = torch.zeros((b, f, n, c), dtype=dtype) if q is None else q
    return (q, q, q, q, torch.zeros((b, f, n, heads)), q, mode, 0.1, heads)


@pytest.mark.parametrize("dtype,c,heads,entry", [
    (torch.bfloat16, 320, 8, "me_video_attention_bwd_dq_tc"),    # d = 40
    (torch.bfloat16, 640, 8, "me_video_attention_bwd_dq_tc"),    # d = 80
    (torch.bfloat16, 32, 4, "me_video_attention_bwd_dq_tc"),     # d = 8
    (torch.bfloat16, 768, 8, "me_video_attention_bwd_dq"),       # d = 96: past 80
    (torch.bfloat16, 1280, 8, "me_video_attention_bwd_dq"),      # d = 160
    (torch.float32, 320, 8, "me_video_attention_bwd_dq"),
    (torch.float32, 640, 8, "me_video_attention_bwd_dq"),
])
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
def test_dq_launch_takes_the_routed_body(lib, dtype, c, heads, entry, mode):
    dq, delta = bwd_mod.video_flash_bwd_dq(*_dq_args(dtype, c, heads, mode))
    assert dq.shape == (2, 3, 50, c) and dq.dtype == dtype
    assert delta.shape == (2, 3, 50, heads) and delta.dtype == torch.float32
    assert lib.calls == [entry]
    tc = int(entry.endswith("_tc"))
    assert dict(_build.launch_counts) == {
        "video_flash_bwd_dq": 1, **({"video_flash_bwd_dq.tc": 1} if tc else {})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,operand", [
    ("fwd_res", "q"), ("fwd_res", "k"), ("dq", "q"), ("dq", "out"), ("dq", "do"),
])
def test_fwd_res_and_dq_reject_misaligned_rows(lib, dtype, kernel, operand):
    """K4 and K5 load 16-byte vectors on both bodies: an operand off a
    16-byte boundary raises before any launch."""
    shape = (2, 3, 50, 320)
    ops = {"q": torch.zeros(shape, dtype=dtype), "k": torch.zeros(shape, dtype=dtype),
           "out": torch.zeros(shape, dtype=dtype), "do": torch.zeros(shape, dtype=dtype)}
    ops[operand] = _off(shape, dtype)
    with pytest.raises(ValueError, match="16-byte boundary"):
        if kernel == "fwd_res":
            bwd_mod._fwd_res_kernel(ops["q"], ops["k"], ops["k"], "motion_frame", 0.1, 8)
        else:
            bwd_mod.video_flash_bwd_dq(ops["q"], ops["k"], ops["k"], ops["out"],
                                       torch.zeros((2, 3, 50, 8)), ops["do"], "motion_frame",
                                       0.1, 8)
    assert lib.calls == [] and not _build.launch_counts


def test_failed_fwd_res_and_dq_launches_raise_and_are_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    q = torch.zeros((2, 3, 50, 320), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        bwd_mod._fwd_res_kernel(q, q, q, "motion_frame", 0.1, 8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        bwd_mod.video_flash_bwd_dq(*_dq_args(torch.bfloat16, 320, 8))
    assert lib.calls == ["me_video_attention_fwd_res_tc", "me_video_attention_bwd_dq_tc"]
    assert not _build.launch_counts


def test_fwd_res_takes_the_plain_version_on_the_cpu(lib):
    """A CPU tensor runs K4's plain version and launches nothing."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 20, 32), generator=gen) for _ in range(3))
    out, lse = bwd_mod.video_flash_fwd_res(q, k, v, "motion_frame", 0.25, 4)
    ref, ref_lse = bwd_mod.video_flash_fwd_res_plain(q, k, v, "motion_frame", 0.25, 4)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
    assert lib.calls == [] and not _build.launch_counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fq,fk,q_off,staged", [
    (8, 8, 0, 8),     # one rank
    (2, 8, 0, 2),     # the shards of a 4-way split of 8 frames: causal, shard 0
    (2, 8, 2, 4),     # reads key frames 0-3, shard 3 all 8
    (2, 8, 6, 8),
    (3, 24, 9, 12),   # one row per thread (Fk > 8)
    (1, 32, 31, 32),
])
def test_temporal_global_launch_takes_k3_body(lib, dtype, causal, fq, fk, q_off, staged):
    """K14 launches K3's TMA-staged body with its (Fq, Fk, q_off) and the
    tile ``temporal_tile`` gives at Fq and the K/V frames its queries read
    (causal: the first q_off + Fq; else all Fk), and counts under its own
    name."""
    c, heads = 320, 8
    q = torch.zeros((2, fq, 50, c), dtype=dtype)
    kv = torch.zeros((2, fk, 50, c), dtype=dtype)
    out = temporal_mod._temporal_global_kernel(q, kv, kv, 0.1, heads, causal, q_off)
    assert out.shape == q.shape and out.dtype == dtype
    assert lib.calls == ["me_temporal_attention_tma"]
    args = lib.args[0]
    assert args[4:10] == (2, fq, fk, 50, heads, c // heads)
    assert args[11:13] == (int(causal), q_off)
    fs = staged if causal else fk
    assert temporal_mod.staged_kv_frames(fq, fk, causal, q_off) == fs
    tile = temporal_mod.temporal_tile(fq, fs, c // heads, heads, dtype, False)
    assert args[13:20] == tuple(tile) and args[20] == _build.DTYPE_CODES[dtype]
    assert dict(_build.launch_counts) == {"temporal_flash_attention_global": 1}


def _temporal_launch(kernel, q, k, v):
    if kernel == "K3":
        return temporal_mod._temporal_kernel(q, k, v, 0.1, 8, True)
    if kernel == "K7":
        return temporal_mod._temporal_bwd_kernel(q, k, v, torch.zeros_like(k), 0.1, 8, True)
    return temporal_mod._temporal_global_kernel(q, k, v, 0.1, 8, True, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["K3", "K7", "K14"])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_temporal_rejects_misaligned_rows(lib, dtype, kernel, operand):
    """The TMA-staged temporal bodies (K3, K7, and K14 on K3's) read their
    slabs as TMA boxes and store 16-byte vectors: a contiguous operand whose
    base is 8 bytes off a 16-byte boundary raises before any launch
    (ROADMAP C3)."""
    fq = 2 if kernel == "K14" else 8
    ops = {"q": (1, fq, 64, 320), "k": (1, 8, 64, 320), "v": (1, 8, 64, 320)}
    xs = {name: _off(shape, dtype) if name == operand else torch.zeros(shape, dtype=dtype)
          for name, shape in ops.items()}
    with pytest.raises(ValueError, match="16-byte boundary"):
        _temporal_launch(kernel, *xs.values())
    assert lib.calls == [] and not _build.launch_counts


@pytest.mark.parametrize("kernel", ["K3", "K7", "K14"])
def test_temporal_launch_on_aligned_rows(lib, kernel):
    """The same launches on aligned operands reach their entry once."""
    fq = 2 if kernel == "K14" else 8
    q = torch.zeros((1, fq, 64, 320), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 64, 320), dtype=torch.bfloat16)
    _temporal_launch(kernel, q, k, k)
    assert lib.calls == ["me_temporal_attention_bwd_tma" if kernel == "K7"
                         else "me_temporal_attention_tma"]
