"""The per-layer readers' arithmetic on a synthetic trace: the union of
device intervals, the idle gaps and their host labels, the kernel-name
rules, the attention roofline share, the MFU."""

import collections
import types

import pytest

from benchmark import harness, trace, work

PEAKS = {"bf16_flops": 1e12, "bytes_per_s": 1e9}


def synthetic_trace() -> trace.Trace:
    """A 1000 us window: two attention kernels, a copy and an elementwise
    kernel, overlapping in part; the host in a convolution during the
    first gap and in a readback during the second."""
    device = [
        ("void me_tc::attention_tc_kernel<48>(me_tc::Params)", 100.0, 300.0),
        ("temporal_attention_tma_kernel", 250.0, 400.0),
        ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", 600.0, 700.0),
        ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>", 650.0, 800.0),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 900.0, 950.0),
    ]
    host = [
        ("bench.denoise_segment", 0.0, 1000.0),
        ("aten::cudnn_convolution", 380.0, 620.0),
        ("cudaLaunchKernel", 500.0, 505.0),
        ("aten::_local_scalar_dense", 790.0, 910.0),
    ]
    return trace.Trace(device=device, host=host, lo=0.0, hi=1000.0)


def run(tr=None, kinds=None, traced=None, phase=None, window_s=2.0, steps=4):
    return harness.Run(phase=phase, setup_s=12.5, window_s=window_s, steps=steps,
                       kinds=collections.Counter(kinds or {"x": steps}), trace=tr,
                       traced_kinds=collections.Counter(traced or {"x": 2}), peaks=PEAKS)


def test_union_and_gaps():
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert trace.union_seconds([]) == 0
    assert trace.idle_gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [
        (0, 10), (30, 50), (60, 100)]
    tr = synthetic_trace()
    # covered: 100-400, 600-800, 900-950
    assert tr.busy_s() == pytest.approx(550e-6)
    assert tr.window_s == pytest.approx(1e-3)


def test_buckets_and_attention_names():
    assert trace.bucket("void me_tc::attention_tc_inj_kernel<48>(me_tc::Params)") == \
        "attention_tc_inj"
    assert trace.bucket("at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>") == \
        "copy"
    assert trace.bucket("sm90_xmma_gemm_bf16bf16") == "matmul"
    assert trace.bucket("something_else") == "other"
    for name in ("attention_tc_kernel", "temporal_bwd_tma_kernel",
                 "pytorch_flash::flash_fwd_kernel", "fmha_cutlassF_bf16_aligned_64x64",
                 "cudnn_generated_fort_native_sdpa_sm90", "attention_tc_dkv_kernel",
                 "video_attention_kernel"):
        assert trace.is_attention(name), name
    for name in ("sm90_xmma_gemm_bf16bf16", "vectorized_layer_norm_kernel", "softmax_warp_forward"):
        assert not trace.is_attention(name), name


def test_idle_gaps_labelled_by_the_innermost_host_operation():
    gaps = dict(synthetic_trace().top_gaps())
    # 0-100 in the span only, 400-600 in the convolution (cudaLaunchKernel is
    # skipped), 800-900 in the readback, 950-1000 in the span
    assert gaps["aten::cudnn_convolution"] == pytest.approx(200e-6)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(100e-6)
    assert gaps["bench.denoise_segment"] == pytest.approx(150e-6)
    ops = synthetic_trace().top_ops()
    assert ops[0] == ["void me_tc::attention_tc_kernel<48>(me_tc::Params)", pytest.approx(200e-6)]


def test_device_idle_elementwise_and_launches():
    r = run(synthetic_trace())
    assert harness.reader("device_idle.infer")(r) == pytest.approx(45.0)
    # the copy (100 us) and the add (150 us) over 2 traced steps
    assert harness.reader("lib_elementwise_ms.train")(r) == pytest.approx(0.125)
    assert harness.reader("launches_per_step.infer")(r) == pytest.approx(2.5)
    assert harness.reader("device_idle.infer")(run(None)) is None


def test_step_times_and_setup():
    r = run(None, window_s=3.0, steps=12)
    assert harness.reader("infer_step_ms")(r) == pytest.approx(250.0)
    assert harness.reader("train_step_ms")(r) == pytest.approx(250.0)
    assert harness.reader("setup_s")(r) == 12.5


def phase_with(sites, flops=0.0, kind="infer", forward_passes=1):
    return types.SimpleNamespace(kind=kind, dtype=types.SimpleNamespace(itemsize=2),
                                 forward_passes=forward_passes,
                                 work=lambda k: {"flops": flops, "sites": sites})


def test_attention_roofline():
    # one compute-bound kernel site (2e5 flops: 0.2 us at 1e12) and one
    # bandwidth-bound (500 elements x 2 bytes: 1 us at 1e9), a cross
    # site and a small spatial site that run outside the attention kernels
    sites = [
        {"kind": "spatial", "nq": 4096, "tokens": 4096, "flops": 2e5, "elems": 10},
        {"kind": "temporal", "nq": 8, "tokens": 1024, "flops": 10, "elems": 500},
        {"kind": "cross", "nq": 4096, "tokens": 4096, "flops": 1e9, "elems": 1e9},
        {"kind": "spatial", "nq": 256, "tokens": 256, "flops": 1e9, "elems": 1e9},
    ]
    assert len(work.kernel_sites(sites)) == 2
    least = work.least_seconds(sites, PEAKS, 2, train=False)
    assert least == pytest.approx(0.2e-6 + 1e-6)
    assert work.least_seconds(sites, PEAKS, 2, train=True) == pytest.approx(3 * least)
    # the trace's two attention kernels (200 + 150 us): one traced step's sites
    r = run(synthetic_trace(), traced={"x": 1}, phase=phase_with(sites))
    assert harness.reader("attn_roofline.infer")(r) == pytest.approx(100 * least / 350e-6)
    r = run(synthetic_trace(), traced={"x": 1}, phase=phase_with(sites, kind="train"))
    assert harness.reader("attn_roofline.train")(r) == pytest.approx(100 * 3 * least / 350e-6)


def test_attention_roofline_reads_nothing_when_the_routing_moves():
    """Forward attention kernels other than one per counted site and pass:
    a small site routed to a kernel or SDPA, a site moved to a plain path,
    or a recompute the phase does not state."""
    sites = [{"kind": "spatial", "nq": 4096, "tokens": 4096, "flops": 2e5, "elems": 10},
             {"kind": "temporal", "nq": 8, "tokens": 1024, "flops": 10, "elems": 500}]
    read = harness.reader("attn_roofline.infer")
    tr = synthetic_trace()
    sdpa = trace.Trace(tr.device + [("pytorch_flash::flash_fwd_kernel", 820.0, 880.0)],
                       tr.host, tr.lo, tr.hi)
    assert read(run(sdpa, traced={"x": 1}, phase=phase_with(sites))) is None
    assert read(run(tr, traced={"x": 1}, phase=phase_with(sites[:1] * 3))) is None
    assert read(run(tr, traced={"x": 1}, phase=phase_with(sites, forward_passes=2))) is None
    # backward kernels are not forward ones: a trained step with its dq / dkv
    bwd = trace.Trace(tr.device + [("attention_tc_dq_kernel<48>", 820.0, 850.0),
                                   ("attention_tc_dkv_kernel<48>", 850.0, 880.0),
                                   ("temporal_bwd_tma_kernel<bf16, 32>", 880.0, 890.0)],
                      tr.host, tr.lo, tr.hi)
    got = read(run(bwd, traced={"x": 1}, phase=phase_with(sites, kind="train")))
    least = work.least_seconds(sites, PEAKS, 2, train=True)
    assert got == pytest.approx(100 * least / 420e-6)
    assert not trace.is_backward("void me_tc::attention_tc_lse_kernel<48>(me_tc::Params)")


def test_mfu_weighs_each_step_kind():
    flops = {"vanilla": 1e12, "injected": 2e12}
    phase = types.SimpleNamespace(work=lambda k: {"flops": flops[k], "sites": []})
    r = run(None, kinds={"vanilla": 4, "injected": 6}, phase=phase, window_s=20.0, steps=10)
    # (4e12 + 12e12) / 20 s / 1e12
    assert harness.reader("mfu.infer")(r) == pytest.approx(80.0)
