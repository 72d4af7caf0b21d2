"""Smoke test of the PyTorch/CUDA port (motioneditor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/*.cu for sm_90a from this checkout
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              at the denoise step's shapes (B=2, F=8, (N, C) in {(4096, 320),
              (1024, 640)}, 8 heads) in bf16 and fp32 (TF32 off), with
              CUDA-event times of both
  4. slice    the injected two-branch denoise segment at full SD-1.5 width
              (UNet + adapter + ControlNet, random init from a seed), bf16,
              512px, 8 frames, injection from block 10, 3 steps over
              timesteps[4:7]; asserts finite output and the per-step kernel
              launch counts, prints ms per step
  5. check    a tiny fp32 segment whose level-0 attention reaches the
              kernels, kernel path against the plain path on the card
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
LOGIT_CAP = 60.0  # the JAX bf16 kernels' score clamp (ops/video_flash.py _CAP)

# per denoise step: UNet blocks 0-3 (4) + source rows of blocks 10-15 (6)
# + ControlNet blocks 0-3 (4) + adapter blocks 0-5 x (attn_temp, attn_pose) (12)
EXPECTED_PER_STEP = {
    "video_flash_attention": 26,
    "video_injection_attention": 6,  # edit rows of blocks 10-15
    "temporal_flash_attention": 16,  # UNet blocks 0-3, 10-15 (10) + adapter 0-5 (6)
}
KERNEL_INFO = {
    "video_flash_attention": ("motioneditor_tpu_torch/csrc/video_attention.cu",
                              "motioneditor_tpu/ops/video_flash.py:248"),
    "video_injection_attention": ("motioneditor_tpu_torch/csrc/video_attention.cu",
                                  "motioneditor_tpu/ops/video_flash.py:591"),
    "temporal_flash_attention": ("motioneditor_tpu_torch/csrc/temporal_attention.cu",
                                 "motioneditor_tpu/ops/temporal_flash.py:208"),
}


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
    results = {name: {"max_abs_err": 0.0} for name in KERNEL_INFO}
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


def phase_check(device):
    """Tiny fp32 segment (32x32 latents: level-0 attention at N = 1024 reaches
    the kernels), kernel path against the plain path, all weights random."""
    import torch
    from torch import nn

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import (
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.models.unet import UNetConfig
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config = UNetConfig(block_out_channels=(32, 64, 64, 64), norm_num_groups=8,
                        attention_heads=4, cross_attention_dim=16)
    cn_config = controlnet_config(config)
    unet, cn = build_models(config, cn_config, device, torch.float32, SEED + 2)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    with torch.no_grad():  # zero-init modules random too, so they take part
        for m in list(unet.modules()) + list(cn.modules()):
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                for p in m.parameters(recurse=False):
                    p.uniform_(-bound, bound, generator=gen)
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
        if use_flash and not all(_build.launch_counts[k] for k in KERNEL_INFO):
            raise AssertionError(f"kernel path skipped a kernel: {_build.launch_counts}")
    err = (outs[True] - outs[False]).abs().max().item()
    log(f"[check] 2-step fp32 segment, kernel vs plain path: max_abs_err={err:.3e}")
    if not torch.isfinite(outs[True]).all() or err > 2e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: {err}")


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
    launches, ms_per_step = phase_slice(device)
    phase_check(device)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "at": r["at"],
        })
    print(json.dumps({"kernels": kernels, "slice_ms_per_step": ms_per_step}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
