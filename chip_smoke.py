"""Smoke test of the PyTorch/CUDA port (motioneditor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/*.cu for sm_90a from this checkout
  3. kernels  each forward CUDA kernel against its plain PyTorch version on
              the card, at the denoise step's shapes (B=2, F=8, (N, C) in
              {(4096, 320), (1024, 640)}, 8 heads) in bf16 and fp32 (TF32
              off), with CUDA-event times of both
  3b. bwd     the backward kernels (K4 residual-saving forward, K5 dq, K6
              dk/dv partials, K7 temporal) against their plain versions and
              autograd of the plain forward, at the null-text shapes (B=1,
              F=8, the same (N, C), modes normal / sparse_causal /
              motion_frame), bf16 and fp32, with times
  4. slice    the injected two-branch denoise segment at full SD-1.5 width
              (UNet + adapter + ControlNet, random init from a seed), bf16,
              512px, 8 frames, injection from block 10, 3 steps over
              timesteps[4:7]; asserts finite output and the per-step kernel
              launch counts, prints ms per step
  5. check    a tiny fp32 segment whose level-0 attention reaches the
              kernels, kernel path against the plain path on the card
  5b. check   a tiny fp32 null-text inversion (32x32 latents, 2 steps, 2
              inner steps), kernel path against the plain path; every
              forward and backward kernel of the path must launch
  6. null     null-text inversion then the edit at full width, bf16, 512px,
              8 frames, batch 1, random [1, 77, 768] text embeddings, a
              5-step schedule: 5 inversion steps (motion_frame), 5 null-text
              steps (inner_steps 1, bf16 compute, fp32 masters), then the
              injected edit over the last 2 steps with the optimized
              per-step uncond embeddings; asserts finite outputs and the
              per-step launch counts, prints ms per step and peak memory
Then one JSON line of per-kernel results, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
FRAMES = 8
LATENT = 64  # 512 px
HEADS = 8
KERNEL_SHAPES = ((4096, 320), (1024, 640))  # (N, C) at 64x64 and 32x32 latents
MODES = ("normal", "sparse_causal", "motion_frame", "dense")
BWD_MODES = ("normal", "sparse_causal", "motion_frame")
NULL_STEPS = 5  # phase 6's schedule
LOGIT_CAP = 60.0  # the JAX bf16 kernels' score clamp (ops/video_flash.py _CAP)

# per denoise step: UNet blocks 0-3 (4) + source rows of blocks 10-15 (6)
# + ControlNet blocks 0-3 (4) + adapter blocks 0-5 x (attn_temp, attn_pose) (12)
EXPECTED_PER_STEP = {
    "video_flash_attention": 26,
    "video_injection_attention": 6,  # edit rows of blocks 10-15
    "temporal_flash_attention": 16,  # UNet blocks 0-3, 10-15 (10) + adapter 0-5 (6)
}
# per inversion step (batch 1, no ControlNet or adapter): UNet blocks 0-3 and
# 10-15 (64x64 and 32x32); the 16x16 and 8x8 sites stay under the size gates
EXPECTED_PER_INVERSION_STEP = {"video_flash_attention": 10, "temporal_flash_attention": 10}
# per null-text step (inner_steps 1): 2 forwards without grad (eps_cond and the
# latent advance) + 1 forward under grad and its backward. In the grad forward
# block 0's attn1 precedes every cross-attention, so nothing there depends on
# the embedding and it launches K1; the other 9 attn1 sites and all 10
# attn_temp sites (each after a cross-attention) take the grad path.
EXPECTED_PER_NULL_STEP = {
    "video_flash_attention": 21,
    "video_flash_fwd_res": 9,
    "video_flash_bwd_dq": 9,
    "video_flash_bwd_dkv": 9,
    "temporal_flash_attention": 30,
    "temporal_flash_attention_bwd": 10,
}
KERNEL_INFO = {
    "video_flash_attention": ("motioneditor_tpu_torch/csrc/video_attention.cu",
                              "motioneditor_tpu/ops/video_flash.py:248"),
    "video_injection_attention": ("motioneditor_tpu_torch/csrc/video_attention.cu",
                                  "motioneditor_tpu/ops/video_flash.py:591"),
    "temporal_flash_attention": ("motioneditor_tpu_torch/csrc/temporal_attention.cu",
                                 "motioneditor_tpu/ops/temporal_flash.py:208"),
    "video_flash_fwd_res": ("motioneditor_tpu_torch/csrc/video_attention.cu",
                            "motioneditor_tpu/ops/video_flash_bwd.py:229"),
    "video_flash_bwd_dq": ("motioneditor_tpu_torch/csrc/video_attention_bwd.cu",
                           "motioneditor_tpu/ops/video_flash_bwd.py:403"),
    "video_flash_bwd_dkv": ("motioneditor_tpu_torch/csrc/video_attention_bwd.cu",
                            "motioneditor_tpu/ops/video_flash_bwd.py:437"),
    "temporal_flash_attention_bwd": ("motioneditor_tpu_torch/csrc/temporal_attention_bwd.cu",
                                     "motioneditor_tpu/ops/temporal_flash.py:190"),
}
FORWARD_KERNELS = ("video_flash_attention", "video_injection_attention",
                   "temporal_flash_attention")
BACKWARD_KERNELS = ("video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv",
                    "temporal_flash_attention_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tolerance(dtype):
    import torch

    # bf16: atol 3e-2 (tests/test_video_flash.py:47) plus torch's bf16 rtol,
    # since one bf16 ulp of an output of magnitude >= 4 is already 0.031
    return dict(atol=2e-5, rtol=0.0) if dtype == torch.float32 else dict(atol=3e-2, rtol=1.6e-2)


def logit_bound(q, k, heads: int, scale: float) -> float:
    """Upper bound on |q.k| * scale over all head pairs (Cauchy-Schwarz)."""
    b, f, n, c = q.shape
    qn = q.float().reshape(b, f, n, heads, -1).norm(dim=-1).amax().item()
    kn = k.float().reshape(b, f, n, heads, -1).norm(dim=-1).amax().item()
    return qn * kn * scale


def phase_kernels(device):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

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

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {name: {"max_abs_err": 0.0} for name in FORWARD_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for n, c in KERNEL_SHAPES:
            shape = (2, FRAMES, n, c)
            q, k, v, k2, v2 = (torch.randn(shape, generator=gen, device=device).to(dtype)
                               for _ in range(5))
            mask = (torch.rand((FRAMES, n), generator=gen, device=device) > 0.5).float()
            scale = (c // HEADS) ** -0.5
            if dtype == torch.bfloat16:
                bound = max(logit_bound(q, k, HEADS, scale), logit_bound(q, k2, HEADS, scale))
                if bound >= LOGIT_CAP:
                    raise AssertionError(f"bf16 inputs reach logit {bound} >= {LOGIT_CAP}")
            cases = [
                (("video_flash_attention", mode),
                 lambda m=mode: video_flash_attention(q, k, v, m, scale, HEADS),
                 lambda m=mode: video_flash_attention_plain(q, k, v, m, scale, HEADS))
                for mode in MODES
            ]
            cases.append((("video_injection_attention", "injection"),
                          lambda: video_injection_attention(q, k, v, k2, v2, mask, scale, HEADS),
                          lambda: video_injection_attention_plain(q, k, v, k2, v2, mask, scale,
                                                                  HEADS)))
            cases.append((("temporal_flash_attention", "causal"),
                          lambda: temporal_flash_attention(q, k, v, scale, HEADS, causal=True),
                          lambda: temporal_flash_attention_plain(q, k, v, scale, HEADS,
                                                                 causal=True)))
            for (name, variant), kernel_fn, plain_fn in cases:
                out = kernel_fn()
                torch.cuda.synchronize()
                ref = plain_fn()
                err = (out.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
                del out, ref
                ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
                dt = str(dtype).replace("torch.", "")
                log(f"[kernels] {name} {variant} {dt} N={n} C={c}: max_abs_err={err:.3e} "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                main_case = (dtype == torch.bfloat16 and n == 4096
                             and variant in ("motion_frame", "injection", "causal"))
                if main_case:
                    r["ms"], r["plain_ms"] = ms, plain_ms
                    r["at"] = f"bf16 B=2 F={FRAMES} N={n} C={c} {variant}"
                torch.cuda.empty_cache()
    return results


def grad_error(got, ref, dtype) -> float:
    """Max |got - ref| over gradients; raises beyond the tolerance of
    tests/test_video_flash_bwd.py: fp32 rtol 1e-4, atol 1e-3; bf16 max error
    relative to the max |ref| < 0.06."""
    import torch

    err = 0.0
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError("gradient is not finite")
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        elif (a - b).abs().max() / (b.abs().max() + 1e-6) >= 0.06:
            raise AssertionError(f"bf16 gradient off by {(a - b).abs().max().item()}")
        err = max(err, (a - b).abs().max().item())
    return err


def plain_autograd(fn, xs, do):
    """Gradients of the plain forward ``fn`` for the output gradient ``do``."""
    import torch

    xs = [x.detach().requires_grad_() for x in xs]
    return torch.autograd.grad(fn(*xs), xs, do)


def phase_bwd_kernels(device):
    """The backward kernels against their plain versions at the null-text
    shapes."""
    import torch

    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention_bwd,
        temporal_flash_attention_bwd_plain,
        temporal_flash_attention_plain,
    )
    from motioneditor_tpu_torch.ops.video_flash import video_flash_attention_plain
    from motioneditor_tpu_torch.ops.video_flash_bwd import (
        combine_partials,
        video_flash_bwd_dkv,
        video_flash_bwd_dq,
        video_flash_bwd_plain,
        video_flash_fwd_res,
        video_flash_fwd_res_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    results = {name: {"max_abs_err": 0.0} for name in BACKWARD_KERNELS}

    def record(name, err, ms, plain_ms, main_case, at):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main_case:
            r["ms"], r["plain_ms"], r["at"] = ms, plain_ms, at

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for n, c in KERNEL_SHAPES:
            q, k, v, do = (torch.randn((1, FRAMES, n, c), generator=gen, device=device).to(dtype)
                           for _ in range(4))
            scale = (c // HEADS) ** -0.5
            if dtype == torch.bfloat16 and logit_bound(q, k, HEADS, scale) >= LOGIT_CAP:
                raise AssertionError(f"bf16 inputs reach logit >= {LOGIT_CAP}")
            for mode in BWD_MODES:
                main_case = dtype == torch.bfloat16 and n == 4096 and mode == "motion_frame"
                at = f"{dt} B=1 F={FRAMES} N={n} C={c} {mode}"
                fwd = lambda: video_flash_fwd_res(q, k, v, mode, scale, HEADS)  # noqa: E731
                fwd_plain = lambda: video_flash_fwd_res_plain(  # noqa: E731
                    q, k, v, mode, scale, HEADS)
                out, lse = fwd()
                torch.cuda.synchronize()
                out_ref, lse_ref = fwd_plain()
                torch.testing.assert_close(out.float(), out_ref.float(), **tolerance(dtype))
                torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
                err = max((out.float() - out_ref.float()).abs().max().item(),
                          (lse - lse_ref).abs().max().item())
                del out, lse
                ms_fwd, plain_fwd_ms = time_ms(fwd), time_ms(fwd_plain)
                record("video_flash_fwd_res", err, ms_fwd, plain_fwd_ms, main_case, at)

                dq_fn = lambda: video_flash_bwd_dq(  # noqa: E731
                    q, k, v, out_ref, lse_ref, do, mode, scale, HEADS)
                dq, delta = dq_fn()
                dkv_fn = lambda: video_flash_bwd_dkv(  # noqa: E731
                    q, k, v, lse_ref, delta, do, mode, scale, HEADS)
                dkp, dvp = dkv_fn()
                got = (dq, combine_partials(dkp, mode).to(dtype),
                       combine_partials(dvp, mode).to(dtype))
                del dkp, dvp
                torch.cuda.synchronize()
                bwd_plain = lambda: video_flash_bwd_plain(  # noqa: E731
                    q, k, v, out_ref, lse_ref, do, mode, scale, HEADS)
                err_plain = grad_error(got, bwd_plain(), dtype)
                err_auto = grad_error(got, plain_autograd(
                    lambda *t: video_flash_attention_plain(*t, mode, scale, HEADS), (q, k, v), do),
                    dtype)
                del got, dq
                torch.cuda.empty_cache()
                ms_dq, ms_dkv, plain_ms = time_ms(dq_fn), time_ms(dkv_fn), time_ms(bwd_plain)
                auto_ms = time_ms(lambda: plain_autograd(
                    lambda *t: video_flash_attention_plain(*t, mode, scale, HEADS), (q, k, v), do))
                record("video_flash_bwd_dq", max(err_plain, err_auto), ms_dq, plain_ms,
                       main_case, at)
                record("video_flash_bwd_dkv", max(err_plain, err_auto), ms_dkv, plain_ms,
                       main_case, at)
                log(f"[bwd] {at}: max_abs_err fwd_res {err:.3e}, bwd vs plain {err_plain:.3e}, "
                    f"vs autograd {err_auto:.3e}; fwd_res {ms_fwd:.3f} ms (plain "
                    f"{plain_fwd_ms:.3f}), dq {ms_dq:.3f} ms, dkv {ms_dkv:.3f} ms, plain bwd "
                    f"{plain_ms:.3f} ms, plain fwd+bwd by autograd {auto_ms:.3f} ms")
                del out_ref, lse_ref, delta
                torch.cuda.empty_cache()

            at = f"{dt} B=1 F={FRAMES} N={n} C={c} causal"
            k7 = lambda: temporal_flash_attention_bwd(q, k, v, do, scale, HEADS)  # noqa: E731
            k7_plain = lambda: temporal_flash_attention_bwd_plain(  # noqa: E731
                q, k, v, do, scale, HEADS)
            got = k7()
            torch.cuda.synchronize()
            err = max(grad_error(got, k7_plain(), dtype), grad_error(got, plain_autograd(
                lambda *t: temporal_flash_attention_plain(*t, scale, HEADS), (q, k, v), do),
                dtype))
            del got
            ms, plain_ms = time_ms(k7), time_ms(k7_plain)
            log(f"[bwd] temporal {at}: max_abs_err {err:.3e}; kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
            record("temporal_flash_attention_bwd", err, ms, plain_ms,
                   dtype == torch.bfloat16 and n == 4096, at)
            del q, k, v, do
            torch.cuda.empty_cache()
    return results


def build_models(config, cn_config, device, dtype, seed: int):
    import torch

    from motioneditor_tpu_torch.models.controlnet import ControlNetModel
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(config)
        cn = ControlNetModel(cn_config)
    init_params(unet, gen)
    init_params(cn, gen)
    return unet.to(dtype).eval(), cn.to(dtype).eval()


def phase_slice(device):
    """The full-width injected denoise segment, bf16, with launch counts."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import (
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.models.unet import UNetConfig
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = UNetConfig(), controlnet_config()
    t0 = time.perf_counter()
    unet, cn = build_models(config, cn_config, device, dtype, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    lat = torch.randn((2, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond = torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
    uncond = torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(
        torch.ones((FRAMES, LATENT, LATENT), device=device), FRAMES).items()}
    schedule = DiffusionSchedule()
    all_ts = schedule.inference_timesteps(50)
    spec = InjectionSpec.from_start_layer(10)
    torch.cuda.synchronize()
    log(f"[slice] models + inputs ready in {time.perf_counter() - t0:.1f} s")

    def run(ts):
        return denoise_segment(unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0,
                               lat, ts, cond, uncond, cond_emb, masks)

    run(all_ts[4:5])  # warm-up step (cuDNN / cuBLAS plans, allocator)
    torch.cuda.synchronize()
    steps = all_ts[4:7]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / len(steps)
    launches = dict(_build.launch_counts)
    log(f"[slice] {len(steps)} steps, {ms_per_step:.1f} ms/step, launches {launches}")
    if out.shape != lat.shape or out.dtype != dtype:
        raise AssertionError(f"slice output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError("slice output is not finite")
    for name, per_step in EXPECTED_PER_STEP.items():
        if launches.get(name, 0) != per_step * len(steps):
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, expected "
                                 f"{per_step} per step x {len(steps)}")
    del unet, cn, out
    torch.cuda.empty_cache()
    return launches, ms_per_step


def build_tiny_models(device, seed: int):
    """A tiny fp32 UNet + ControlNet whose 32x32 level-0 attention (N = 1024)
    reaches the kernels, all weights random (zero-init modules too, so they
    take part)."""
    import torch
    from torch import nn

    from motioneditor_tpu_torch.models.controlnet import controlnet_config
    from motioneditor_tpu_torch.models.unet import UNetConfig

    config = UNetConfig(block_out_channels=(32, 64, 64, 64), norm_num_groups=8,
                        attention_heads=4, cross_attention_dim=16)
    cn_config = controlnet_config(config)
    unet, cn = build_models(config, cn_config, device, torch.float32, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in list(unet.modules()) + list(cn.modules()):
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                for p in m.parameters(recurse=False):
                    p.uniform_(-bound, bound, generator=gen)
    return config, cn_config, unet, cn, gen


def phase_check(device):
    """Tiny fp32 segment (32x32 latents: level-0 attention at N = 1024 reaches
    the kernels), kernel path against the plain path, all weights random."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 2)
    f, hw = 3, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond = 0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
    uncond = 0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    ts = schedule.inference_timesteps(50)[4:6]
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, InjectionSpec.from_start_layer(10),
            7.5, 1.0, lat, ts, cond, uncond, cond_emb, masks, use_flash=use_flash)
        torch.cuda.synchronize()
        if use_flash and not all(_build.launch_counts[k] for k in FORWARD_KERNELS):
            raise AssertionError(f"kernel path skipped a kernel: {_build.launch_counts}")
    err = (outs[True] - outs[False]).abs().max().item()
    log(f"[check] 2-step fp32 segment, kernel vs plain path: max_abs_err={err:.3e}")
    if not torch.isfinite(outs[True]).all() or err > 2e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: {err}")


def phase_null_check(device):
    """Tiny fp32 null-text inversion (2 steps, 2 inner steps, the early stop
    off so both run), kernel path against the plain path."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.pipelines.editor import null_text_inversion
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, _, unet, _, gen = build_tiny_models(device, SEED + 6)
    lat = 0.3 * torch.randn((1, 3, 32, 32, 4), generator=gen, device=device)
    cond = 0.3 * torch.randn((1, 7, 16), generator=gen, device=device)
    uncond0 = 0.3 * torch.randn((1, 7, 16), generator=gen, device=device)
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = null_text_inversion(
            unet, config, DiffusionSchedule(), lat, cond, uncond0, num_steps=2, inner_steps=2,
            early_stop_epsilon=-1.0, use_flash=use_flash)
        torch.cuda.synchronize()
        launched = dict(_build.launch_counts)
        if use_flash:
            needed = ("video_flash_attention", "temporal_flash_attention") + BACKWARD_KERNELS
            if not all(launched.get(k) for k in needed):
                raise AssertionError(f"kernel path skipped a kernel: {launched}")
            log(f"[null-check] kernel path launches {launched}")
        elif launched:
            raise AssertionError(f"plain path launched kernels: {launched}")
    (x_k, u_k), (x_p, u_p) = outs[True], outs[False]
    err_x = (x_k - x_p).abs().max().item()
    err_u = (u_k - u_p).abs().max().item()
    log(f"[null-check] 2-step fp32 null-text, kernel vs plain path: x_T max_abs_err="
        f"{err_x:.3e}, uncond max_abs_err={err_u:.3e}")
    finite = torch.isfinite(x_k).all() and torch.isfinite(u_k).all()
    if not finite or err_x > 2e-3 or err_u > 2e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: {err_x}, {err_u}")


def expect_counts(phase: str, launches: dict, per_step: dict, steps: int) -> None:
    """The launches of a run must be ``per_step`` x steps, and no other."""
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")


def phase_null_text(device):
    """Null-text inversion and the edit with per-step uncond embeddings at
    full width, bf16, batch 1, with launch counts per step."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import (
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.models.unet import UNetConfig
    from motioneditor_tpu_torch.pipelines.editor import (
        ddim_invert,
        denoise_segment,
        null_optimization,
        null_text_inversion,
    )
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = UNetConfig(), controlnet_config()
    unet, cn = build_models(config, cn_config, device, dtype, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    lat = torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond = torch.randn((1, 77, 768), generator=gen, device=device)
    uncond0 = torch.randn((1, 77, 768), generator=gen, device=device)
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(
        torch.ones((FRAMES, LATENT, LATENT), device=device), FRAMES).items()}
    schedule = DiffusionSchedule()
    opt = dict(inner_steps=1, base_lr=1e-2, guidance_scale=7.5, compute_dtype="bfloat16")
    # warm-up through the entry point: one inversion and one null-text step
    null_text_inversion(unet, config, schedule, lat, cond, uncond0, num_steps=1, **opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings, paths = {}, {}

    def timed(phase, steps, fn):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[phase] = (time.perf_counter() - t0) * 1e3 / steps
        paths[phase] = dict(_build.launch_counts)
        log(f"[null] {phase}: {steps} steps, {timings[phase]:.1f} ms/step, "
            f"launches {paths[phase]}")
        return out

    x_t, all_lat = timed("inversion", NULL_STEPS, lambda: ddim_invert(
        unet, config, schedule, lat, cond, NULL_STEPS, normal_infer=False))
    uncond = timed("null_text", NULL_STEPS, lambda: null_optimization(
        unet, config, schedule, all_lat, cond, uncond0, NULL_STEPS, opt["inner_steps"],
        opt["base_lr"], opt["guidance_scale"], compute_dtype=opt["compute_dtype"]))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ts = schedule.inference_timesteps(NULL_STEPS)

    def edit(lo, hi):
        return denoise_segment(
            unet, config, cn, cn_config, schedule, NULL_STEPS, InjectionSpec.from_start_layer(10),
            7.5, 1.0, torch.cat([x_t, x_t]), ts[lo:hi], cond.to(dtype).expand(2, -1, -1), None,
            cond_emb, masks, seg_uncond=uncond[lo:hi])

    edit(NULL_STEPS - 2, NULL_STEPS - 1)  # warm-up step of the batch-4 edit
    out = timed("edit", 2, lambda: edit(NULL_STEPS - 2, NULL_STEPS))
    log(f"[null] peak memory of inversion + null-text: {peak_gb:.2f} GiB")
    if x_t.shape != lat.shape or uncond.shape != (NULL_STEPS, 1, 77, 768):
        raise AssertionError(f"shapes {tuple(x_t.shape)}, {tuple(uncond.shape)}")
    if uncond.dtype != torch.float32 or out.shape != (2, *lat.shape[1:]):
        raise AssertionError(f"uncond {uncond.dtype}, edit {tuple(out.shape)}")
    for name, t in (("x_T", x_t), ("uncond", uncond), ("edit", out)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite")
    if torch.equal(uncond[0], uncond0[0]):
        raise AssertionError("null-text optimization left the embedding unchanged")
    expect_counts("inversion", paths["inversion"], EXPECTED_PER_INVERSION_STEP, NULL_STEPS)
    expect_counts("null_text", paths["null_text"], EXPECTED_PER_NULL_STEP, NULL_STEPS)
    expect_counts("edit", paths["edit"], EXPECTED_PER_STEP, 2)
    del unet, cn, out
    torch.cuda.empty_cache()
    return paths, {"inversion_ms_per_step": timings["inversion"],
                   "null_text_ms_per_step": timings["null_text"],
                   "edit_ms_per_step": timings["edit"], "null_text_peak_gib": peak_gb}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from motioneditor_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    path, build_log = _build.build()
    if build_log:
        (path.parent / "build.log").write_text(build_log)
    _build.kernels()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results = phase_kernels(device)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    results.update(phase_bwd_kernels(device))
    log(f"[bwd] done in {time.perf_counter() - t0:.1f} s")
    launches, ms_per_step = phase_slice(device)
    phase_check(device)
    phase_null_check(device)
    paths, null_metrics = phase_null_text(device)
    paths["denoise"] = launches

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p.get(name, 0) for p in paths.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "at": r["at"],
        })
    print(json.dumps({"kernels": kernels, "slice_ms_per_step": ms_per_step, **null_metrics,
                      "launches_by_path": paths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
