"""Smoke test of the PyTorch/CUDA port (motioneditor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/*.cu for sm_90a from this checkout
  3. kernels  each forward CUDA kernel against its plain PyTorch version on
              the card, at the denoise step's shapes (B=2, F=8, (N, C) in
              {(4096, 320), (1024, 640)}, 8 heads) in bf16 and fp32 (TF32
              off), with CUDA-event times of both; the split-head kernels
              (K8 flash_attention, K9 fused_injection_attention) at the auto
              path's shapes (q [2, 8, 8, N, d], K/V over 2N keys, (N, d) in
              {(4096, 40), (1024, 80)}); one PyTorch library call where one
              computes the same function (scaled_dot_product_attention for
              K8, K1's normal mode and K3 causal), timed as a yardstick
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
  7. pipe     MotionEditorPipeline from frames to frames at full width with
              the VAE and the CLIP text encoder (StubTokenizer), bf16, 512px,
              8 frames, random init from the seed: encode_video ->
              null_text_inversion -> the edit (mask mode) -> decode, on a
              5-step schedule with start_step 3 (3 vanilla steps, 2
              injected); asserts a finite [2, 8, 512, 512, 3] video in
              [0, 1] and the launch counts, prints the time of each part
  8. auto     the denoise segment in auto-mask mode at full width, bf16, 3
              steps; asserts the per-step launch counts, prints ms per step
  8b. check   tiny fp32 checks, kernel path against plain path: an auto
              segment (K8 at its real call site) and the split-head branch
              of the mask injection at a head dim the packed kernels
              decline (d = 9), where K8 and K9 launch
  3c. norm    (run after phase 3b) the GroupNorm pair statistics (K10) at
              [1, 32768, 320] (x, x) and (dy, x), [8, 4096, 320] and
              [1, 512, 2560], and the fused add + LayerNorm (K11) at
              [1, 8, 4096, 320] and [1, 8, 1024, 640], against their plain
              versions in bf16 and fp32, with times; the GroupNorm Function's
              dx, dscale and dbias against autograd of the plain group_norm;
              F.group_norm and add + F.layer_norm timed as yardsticks
  9. train check  a tiny fp32 stage-1 step and stage-2 step with
              MOTIONEDITOR_FUSED_GN / _LN on and the kernels (K1, K3-K7, K10
              forward and backward, K11), against the plain path with both
              off: loss, the trainables' gradients, the parameters after one
              AdamW step
  10. train   stage 1 then stage 2 at full SD-1.5 width, random init from
              the seed, bf16 frozen weights with fp32 masters, 512 px, 8
              frames, batch 1, gradient checkpointing: a warm-up step and 3
              steps each with both knobs on, asserting finite losses, that
              only the trainables moved and the per-step launch counts; then
              the same steps with both knobs off; ms per step and peak memory
Then one JSON line of per-kernel results, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# per auto-mode segment step: UNet blocks 0-3 (4) + ControlNet 0-3 (4) + adapter
# 0-5 x 2 (12); blocks 10-15 run K8 three times each (source rows, fg, bg)
EXPECTED_PER_AUTO_STEP = {
    "video_flash_attention": 20,
    "temporal_flash_attention": 16,
    "flash_attention": 18,
}
PIPE_STEPS, PIPE_START = 5, 3  # phase 7: 3 vanilla steps, then 2 injected
# a vanilla step launches what an injected one does, but for K2: blocks 10-15
# run K1 on all four rows instead of K1 on the source rows and K2 on the edit rows
EXPECTED_PER_VANILLA_STEP = {"video_flash_attention": 26, "temporal_flash_attention": 16}
AUTO_SHAPES = ((4096, 40), (1024, 80))  # (N, d) of the auto path's K8 / K9 calls
# K10 [B, S, C] at 512 px and 8 frames: a pooled level-0 resnet GroupNorm, the
# per-frame transformer one, the widest up-block input; K11 [B, F, N, C] at the
# two gated levels
PAIR_STATS_SHAPES = ((1, 32768, 320), (8, 4096, 320), (1, 512, 2560))
ADD_LN_SHAPES = ((1, 8, 4096, 320), (1, 8, 1024, 640))
TRAIN_STEPS = 3
# per training step, gradient checkpointing on, both knobs on (derived in
# PERF.md): stage 1 trains attn1.to_q / attn2.to_q / attn_temp of every block,
# so the 10 gated attn1 sites take K4 (again in the recompute) and K5 / K6,
# the 10 gated attn_temp sites K3 (twice) and K7; K10 61 forward + 58
# recomputed + 58 backward; K11 30 forward + 30 recomputed
EXPECTED_PER_STAGE1_STEP = {
    "video_flash_fwd_res": 20, "video_flash_bwd_dq": 10, "video_flash_bwd_dkv": 10,
    "temporal_flash_attention": 20, "temporal_flash_attention_bwd": 10,
    "channel_pair_stats": 177, "add_layer_norm": 60,
}
# stage 2: the ControlNet (no grad) K1 4, K10 27, K11 8; the UNet's down path
# (no grad) K1 4, K3 4; the adapter (blocks 0-5 gated) K4 12, K3 6; the up
# path K4 6 + 6 recomputed, K3 6 + 6; backward K5 / K6 12 + 6, K7 6 + 6; K10
# 61 forward + 33 recomputed + 34 backward; K11 30 forward + 18 recomputed
EXPECTED_PER_STAGE2_STEP = {
    "video_flash_attention": 8, "video_flash_fwd_res": 24, "video_flash_bwd_dq": 18,
    "video_flash_bwd_dkv": 18, "temporal_flash_attention": 22,
    "temporal_flash_attention_bwd": 12, "channel_pair_stats": 155, "add_layer_norm": 56,
}
NORM_KERNELS = ("channel_pair_stats", "add_layer_norm")
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense (no tensor cores in fp32)
PEAK_BYTES = 3.35e12
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
    "flash_attention": ("motioneditor_tpu_torch/csrc/split_attention.cu",
                        "motioneditor_tpu/ops/flash_attention.py:222"),
    "fused_injection_attention": ("motioneditor_tpu_torch/csrc/split_attention.cu",
                                  "motioneditor_tpu/ops/injection_flash.py:268"),
    "channel_pair_stats": ("motioneditor_tpu_torch/csrc/norm_stats.cu",
                           "motioneditor_tpu/ops/gn_stats.py:78"),
    "add_layer_norm": ("motioneditor_tpu_torch/csrc/add_layer_norm.cu",
                       "motioneditor_tpu/ops/fused_norm.py:73"),
}
SPLIT_KERNELS = ("flash_attention", "fused_injection_attention")
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


def bound(flops: float, moved: float, dtype) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    dt = str(dtype).replace("torch.", "")
    ops_ms = flops / PEAK_FLOPS[dt] * 1e3
    bytes_ms = moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": moved}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def video_work(name: str, variant: str, q) -> float:
    """Operations of the packed-head kernels on q [B, F, N, C]: two products
    (QK^T, PV) of 2*d flops per (query, key, head); the causal temporal
    kernel forms F(F+1)/2 frame pairs per site."""
    b, f, n, c = q.shape
    if name == "temporal_flash_attention":
        return 4.0 * b * n * c * f * (f + 1) / 2
    keys = {"normal": n, "sparse_causal": 2 * n, "motion_frame": 2 * n, "dense": f * n,
            "injection": 3 * n}[variant]  # injection: 2N source keys scored once, N target
    return 4.0 * b * f * n * keys * c


def library_time(dtype, ref, fn) -> float:
    """The time of one PyTorch library call ``fn``, a yardstick only, after
    checking that it computes ``ref`` within the kernels' tolerance."""
    import torch

    torch.testing.assert_close(fn().float(), ref.float(), **tolerance(dtype))
    return time_ms(fn)


def split_logit_bound(q, k, scale: float) -> float:
    """Upper bound on |q.k| * scale for split-head [..., H, N, d] operands."""
    return q.float().norm(dim=-1).amax().item() * k.float().norm(dim=-1).amax().item() * scale


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

    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {name: {"max_abs_err": 0.0} for name in FORWARD_KERNELS}

    def split(x):  # [B, F, N, C] -> [B*F, H, N, d], a view
        b, f, n, c = x.shape
        return x.view(b * f, n, HEADS, c // HEADS).transpose(1, 2)

    def temporal(x):  # [B, F, N, C] -> [B*N, H, F, d], a view
        b, f, n, c = x.shape
        return x.view(b, f, n, HEADS, c // HEADS).permute(0, 2, 3, 1, 4).flatten(0, 1)

    for dtype in (torch.bfloat16, torch.float32):
        for n, c in KERNEL_SHAPES:
            shape = (2, FRAMES, n, c)
            q, k, v, k2, v2 = (torch.randn(shape, generator=gen, device=device).to(dtype)
                               for _ in range(5))
            mask = (torch.rand((FRAMES, n), generator=gen, device=device) > 0.5).float()
            scale = (c // HEADS) ** -0.5
            if dtype == torch.bfloat16:
                top = max(logit_bound(q, k, HEADS, scale), logit_bound(q, k2, HEADS, scale))
                if top >= LOGIT_CAP:
                    raise AssertionError(f"bf16 inputs reach logit {top} >= {LOGIT_CAP}")
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
                ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
                dt = str(dtype).replace("torch.", "")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                main_bf16 = dtype == torch.bfloat16 and n == 4096
                lib = ""
                if main_bf16 and variant in ("normal", "causal"):
                    # the library call gets its layout for free: split-head views of
                    # q, k, v, or [B*N, H, F, d] copies made before the timing
                    view = split if variant == "normal" else temporal
                    lq, lk, lv = view(q), view(k), view(v)
                    lib_fn = lambda: library_sdpa(  # noqa: E731
                        lq, lk, lv, is_causal=variant == "causal", scale=scale)
                    r["library_ms"] = library_time(dtype, view(ref), lib_fn)
                    del lq, lk, lv
                    r["library_at"] = f"bf16 B=2 F={FRAMES} N={n} C={c} {variant}"
                    lib = f", library {r['library_ms']:.3f} ms"
                del out, ref
                log(f"[kernels] {name} {variant} {dt} N={n} C={c}: max_abs_err={err:.3e} "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}")
                if main_bf16 and variant in ("motion_frame", "injection", "causal"):
                    r["ms"], r["plain_ms"] = ms, plain_ms
                    r["at"] = f"bf16 B=2 F={FRAMES} N={n} C={c} {variant}"
                    extra = (k2, v2, mask) if variant == "injection" else ()
                    r.update(bound(video_work(name, variant, q), nbytes(q, k, v, q, *extra),
                                   dtype))
                torch.cuda.empty_cache()
    results.update(phase_split_kernels(device, gen))
    return results


def phase_split_kernels(device, gen):
    """K8 and K9 against their plain versions at the auto path's shapes."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    from motioneditor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from motioneditor_tpu_torch.ops.injection_flash import (
        fused_injection_attention,
        fused_injection_attention_plain,
    )

    results = {name: {"max_abs_err": 0.0} for name in SPLIT_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for n, d in AUTO_SHAPES:
            lead = (2, FRAMES, HEADS)
            q, kt, vt = (torch.randn((*lead, n, d), generator=gen, device=device).to(dtype)
                         for _ in range(3))
            k, v = (torch.randn((*lead, 2 * n, d), generator=gen, device=device).to(dtype)
                    for _ in range(2))
            mask = (torch.rand((FRAMES, 2 * n), generator=gen, device=device) > 0.5).float()
            scale = d ** -0.5
            if dtype == torch.bfloat16:
                b_ = max(split_logit_bound(q, k, scale), split_logit_bound(q, kt, scale))
                if b_ >= LOGIT_CAP:
                    raise AssertionError(f"bf16 inputs reach logit {b_} >= {LOGIT_CAP}")
            main = dtype == torch.bfloat16 and n == 4096
            at = f"{dt} q [2, {FRAMES}, {HEADS}, {n}, {d}], 2N source keys"
            cases = (
                ("flash_attention", lambda: flash_attention(q, k, v, scale),
                 lambda: flash_attention_plain(q, k, v, scale),
                 4.0 * q.numel() * 2 * n, nbytes(q, k, v, q)),
                ("fused_injection_attention",
                 lambda: fused_injection_attention(q, k, v, mask, kt, vt, scale),
                 lambda: fused_injection_attention_plain(q, k, v, mask, kt, vt, scale),
                 4.0 * q.numel() * 3 * n, nbytes(q, k, v, mask, kt, vt, q)),
            )
            for name, kernel_fn, plain_fn, flops, moved in cases:
                out = kernel_fn()
                torch.cuda.synchronize()
                ref = plain_fn()
                err = (out.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
                ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                lib = ""
                if name == "flash_attention":
                    lib_fn = lambda: library_sdpa(q.flatten(0, 1), k.flatten(0, 1),  # noqa: E731
                                                  v.flatten(0, 1), scale=scale)
                    lib_ms = library_time(dtype, ref.flatten(0, 1), lib_fn)
                    lib = f", library {lib_ms:.3f} ms"
                    if main:
                        r["library_ms"], r["library_at"] = lib_ms, at
                del out, ref
                log(f"[kernels] {name} {at}: max_abs_err={err:.3e} kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms{lib}")
                if main:
                    r.update(ms=ms, plain_ms=plain_ms, at=at, **bound(flops, moved, dtype))
                torch.cuda.empty_cache()
            del q, k, v, kt, vt, mask
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

    def record(name, err, ms, plain_ms, main_case, at, flops, moved):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main_case:
            r.update(ms=ms, plain_ms=plain_ms, at=at, **bound(flops, moved, dtype))

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
                # the forward's 2 products per (query, key, head); dq recomputes S and
                # forms dP and dQ (3), dk/dv form S, dP, dV and dK (4)
                work = video_work("video_flash_attention", mode, q)
                lse_bytes = nbytes(lse_ref)
                record("video_flash_fwd_res", err, ms_fwd, plain_fwd_ms, main_case, at, work,
                       nbytes(q, k, v, q) + lse_bytes)

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
                       main_case, at, 1.5 * work, nbytes(q, k, v, q, do, q) + 2 * lse_bytes)
                slots = 1 if mode == "normal" else 2  # fp32 dk / dv partials per source slot
                record("video_flash_bwd_dkv", max(err_plain, err_auto), ms_dkv, plain_ms,
                       main_case, at, 2.0 * work,
                       nbytes(q, k, v, do) + 2 * lse_bytes + 2 * slots * q.numel() * 4)
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
                   dtype == torch.bfloat16 and n == 4096, at,
                   2.5 * video_work("temporal_flash_attention", "causal", q), 7 * nbytes(q))
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


def scaled(counts: dict, steps: int) -> dict:
    return {k: n * steps for k, n in counts.items()}


def add_counts(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def phase_pipeline(device):
    """MotionEditorPipeline from frames to frames at full width, bf16:
    encode_video -> null_text_inversion -> the edit -> decode."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.clip_text import CLIPTextModel, StubTokenizer
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.vae import AutoencoderKL
    from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

    dtype = torch.bfloat16
    t_all = time.perf_counter()
    unet, cn = build_models(*pipeline_configs(), device, dtype, SEED + 10)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    with torch.device(device):
        vae, text = AutoencoderKL(), CLIPTextModel()
    for m in (vae, text):
        init_params(m, gen)
        m.to(dtype).eval()
    pipe = MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                tokenizer=StubTokenizer(), unet_config=pipeline_configs()[0])
    size = 8 * LATENT
    video = (torch.rand((1, FRAMES, size, size, 3), generator=gen, device=device) * 2 - 1)
    skeleton = torch.rand((FRAMES, size, size, 3), generator=gen, device=device)
    masks = torch.zeros((FRAMES, size, size), device=device)
    masks[:, size // 4: 3 * size // 4, size // 3: 2 * size // 3] = 1.0  # the protagonist's box
    prompts = ["a man is dancing", "a man is jumping"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, paths = {}, {}

    def timed(part, fn, path=None):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[part] = (time.perf_counter() - t0) * 1e3
        if path is not None:
            paths[path] = dict(_build.launch_counts)
        return out

    t_run = time.perf_counter()
    timed("prompt_encode_ms", lambda: pipe.encode_prompt(prompts))
    latents = timed("vae_encode_ms", lambda: pipe.encode_video(
        video.to(dtype), generator=torch.Generator(device=device).manual_seed(SEED + 12)))
    x_t, uncond = timed("null_text_inversion_ms", lambda: pipe.null_text_inversion(
        latents, prompts[0], num_steps=PIPE_STEPS), "pipeline_inversion")
    lat = timed("edit_ms", lambda: pipe(
        prompts, torch.cat([x_t, x_t]), skeleton, source_masks=masks, uncond_embeddings=uncond,
        num_inference_steps=PIPE_STEPS, start_step=PIPE_START, decode=False), "pipeline_edit")
    out = timed("vae_decode_ms", lambda: pipe.decode_latents(lat))
    metrics = {k: v for k, v in times.items() if k.endswith("ms")}
    metrics.update(
        inversion_null_text_ms_per_step=times["null_text_inversion_ms"] / PIPE_STEPS,
        edit_ms_per_step=times["edit_ms"] / PIPE_STEPS,
        run_s=time.perf_counter() - t_run, total_s=time.perf_counter() - t_all,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[pipe] {json.dumps(metrics)}")
    log(f"[pipe] launches {paths}")
    if out.shape != (2, FRAMES, size, size, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"pipeline output {tuple(out.shape)} is not a finite video")
    if out.min() < 0 or out.max() > 1:
        raise AssertionError("pipeline output leaves [0, 1]")
    expect_counts("pipeline_inversion", paths["pipeline_inversion"], add_counts(
        scaled(EXPECTED_PER_INVERSION_STEP, PIPE_STEPS),
        scaled(EXPECTED_PER_NULL_STEP, PIPE_STEPS)), 1)
    expect_counts("pipeline_edit", paths["pipeline_edit"], add_counts(
        scaled(EXPECTED_PER_VANILLA_STEP, PIPE_START),
        scaled(EXPECTED_PER_STEP, PIPE_STEPS - PIPE_START)), 1)
    del pipe, vae, text, out
    return unet, cn, paths, metrics


def pipeline_configs():
    from motioneditor_tpu_torch.models.controlnet import controlnet_config
    from motioneditor_tpu_torch.models.unet import UNetConfig

    return UNetConfig(), controlnet_config()


def phase_auto(device, unet, cn):
    """The denoise segment in auto-mask mode at full width, bf16, 3 steps."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    lat = torch.randn((2, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond, uncond = (torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
                    for _ in range(2))
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    src = torch.zeros((FRAMES, LATENT, LATENT), device=device)
    src[:, 16:48, 20:44] = 1.0
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(src, FRAMES).items()}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    all_ts = schedule.inference_timesteps(50)
    spec = InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1,))

    def run(ts):
        return denoise_segment(unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0, lat,
                               ts, cond, uncond, cond_emb, masks)

    run(all_ts[4:5])  # warm-up step
    torch.cuda.synchronize()
    steps = all_ts[4:7]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / len(steps)
    launches = dict(_build.launch_counts)
    log(f"[auto] {len(steps)} steps, {ms_per_step:.1f} ms/step, launches {launches}")
    if out.shape != lat.shape or not torch.isfinite(out).all():
        raise AssertionError("auto segment output is not finite")
    expect_counts("auto", launches, EXPECTED_PER_AUTO_STEP, len(steps))
    return launches, ms_per_step


def phase_split_check(device):
    """Tiny fp32 checks of K8 and K9 at their call sites, kernel path
    against plain path: an auto segment, and the mask injection at a head
    dim the packed kernels decline."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        injected_spatial_attention,
    )
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.ops.attention import Attention
    from motioneditor_tpu_torch.ops.video_flash import video_flash_supported
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 14)
    f, hw = 3, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond = (0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
                    for _ in range(2))
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    spec = InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1, 2),
                                          auto_thres=0.3)
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0, lat,
            schedule.inference_timesteps(50)[4:6], cond, uncond, cond_emb, masks,
            use_flash=use_flash)
        torch.cuda.synchronize()
        if use_flash and not _build.launch_counts["flash_attention"]:
            raise AssertionError(f"the auto segment skipped K8: {_build.launch_counts}")
    err = (outs[True] - outs[False]).abs().max().item()
    log(f"[split-check] 2-step fp32 auto segment, kernel vs plain path: max_abs_err={err:.3e}")
    if not torch.isfinite(outs[True]).all() or err > 2e-3:
        raise AssertionError(f"auto kernel path disagrees with the plain path: {err}")

    c, heads, n = 36, 4, 1024  # d = 9
    if video_flash_supported(c, heads):
        raise AssertionError("the packed kernels were meant to decline d = 9")
    with torch.device(device):
        attn = Attention(c, heads=heads)
    with torch.no_grad():
        for prm in attn.parameters():
            prm.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
        x = 0.5 * torch.randn((4, f, n, c), generator=gen, device=device)
        mask = (torch.rand((f, n, 1), generator=gen, device=device) > 0.5).float()
        _build.reset_launch_counts()
        got = injected_spatial_attention(attn, x, heads, mask)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        want = injected_spatial_attention(attn, x, heads, mask, use_flash=False)
    err = (got - want).abs().max().item()
    log(f"[split-check] split-head mask injection, C={c} heads={heads} N={n}: launches "
        f"{launches}, kernel vs plain path max_abs_err={err:.3e}")
    expect_counts("split_head", launches, {"flash_attention": 1,
                                           "fused_injection_attention": 1}, 1)
    if err > 2e-5:
        raise AssertionError(f"split-head kernels disagree with the plain path: {err}")
    return launches


@contextlib.contextmanager
def norm_knobs(on: bool):
    """MOTIONEDITOR_FUSED_GN and MOTIONEDITOR_FUSED_LN set to ``on`` inside."""
    keys = ("MOTIONEDITOR_FUSED_GN", "MOTIONEDITOR_FUSED_LN")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" if on else "0" for k in keys})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sum_tolerance(terms, got, ref, what: str) -> float:
    """fp32 sums in two orders: |got - ref| <= 1e-4 x the sum of the terms'
    magnitudes per channel (the summation error bound of either order at
    these lengths is a few 1e-5 of it). Returns the max abs error."""
    err = (got - ref).abs()
    if (err > 1e-4 * terms).any():
        raise AssertionError(f"{what}: off by {(err / terms).max().item():.3e} of |terms|")
    return err.max().item()


def phase_norm_kernels(device):
    """K10 and K11 against their plain versions at the training path's
    shapes; the GroupNorm Function's gradients against autograd of the plain
    group_norm; F.group_norm and add + F.layer_norm as yardsticks."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from motioneditor_tpu_torch.models.layers import group_norm
    from motioneditor_tpu_torch.ops.fused_norm import add_layer_norm, add_layer_norm_plain
    from motioneditor_tpu_torch.ops.gn_stats import (
        channel_pair_stats,
        channel_pair_stats_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    results = {name: {"max_abs_err": 0.0, "library_ms": None} for name in NORM_KERNELS}
    yardsticks = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for shape in PAIR_STATS_SHAPES:
            x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device=device).to(dtype)
            for pair, (a, b) in (("x,x", (x, x)), ("dy,x", (dy, x))):
                fn = lambda: channel_pair_stats(a, b)  # noqa: E731
                plain = lambda: channel_pair_stats_plain(a, b)  # noqa: E731
                got = fn()
                torch.cuda.synchronize()
                ref = plain()
                af, bf = a.float(), b.float()
                err = max(sum_tolerance(af.abs().sum(1), got[0], ref[0], f"K10 s1 {shape}"),
                          sum_tolerance((af * bf).abs().sum(1), got[1], ref[1], f"K10 s2 {shape}"))
                del af, bf
                again = fn()
                if not all(torch.equal(g, h) for g, h in zip(got, again)):
                    raise AssertionError("K10 is not deterministic")
                ms, plain_ms = time_ms(fn, reps=20), time_ms(plain, reps=20)
                r = results["channel_pair_stats"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                at = f"{dt} {list(shape)} ({pair})"
                log(f"[norm] channel_pair_stats {at}: max_abs_err={err:.3e} kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
                if dtype == torch.bfloat16 and shape == PAIR_STATS_SHAPES[0] and pair == "x,x":
                    moved = nbytes(a) + 2 * got[0].numel() * 4
                    r.update(ms=ms, plain_ms=plain_ms, at=at,
                             **bound(3.0 * a.numel(), moved, dtype))
                    # yardstick: one GroupNorm, statistics and normalization, on a
                    # channels-first copy made before the timing
                    xc = a.transpose(1, 2).contiguous()
                    w = torch.ones(shape[-1], device=device, dtype=dtype)
                    yardsticks["F.group_norm_ms"] = time_ms(
                        lambda: F.group_norm(xc, 32, w, w, 1e-5), reps=20)
                    yardsticks["F.group_norm_at"] = at
                    del xc
            del x, dy
            torch.cuda.empty_cache()
        for shape in ADD_LN_SHAPES:
            t = torch.randn(shape, generator=gen, device=device).to(dtype)
            d = (torch.randn(shape, generator=gen, device=device) * 0.5 + 0.2).to(dtype)
            norm = nn.LayerNorm(shape[-1], device=device)
            with torch.no_grad():
                norm.weight.normal_(1.0, 0.3, generator=gen)
                norm.bias.normal_(0.0, 0.2, generator=gen)
            fn = lambda: add_layer_norm(norm, t, d)  # noqa: E731
            plain = lambda: add_layer_norm_plain(t, d, norm.weight, norm.bias)  # noqa: E731
            with torch.no_grad():
                got = fn()
                torch.cuda.synchronize()
                ref = plain()
                tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else tolerance(dtype)
                for g, h in zip(got, ref):
                    torch.testing.assert_close(g.float(), h.float(), **tol)
                err = max((g.float() - h.float()).abs().max().item() for g, h in zip(got, ref))
                ms, plain_ms = time_ms(fn, reps=20), time_ms(plain, reps=20)
            r = results["add_layer_norm"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            at = f"{dt} {list(shape)}"
            log(f"[norm] add_layer_norm {at}: max_abs_err={err:.3e} kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
            if dtype == torch.bfloat16 and shape == ADD_LN_SHAPES[0]:
                r.update(ms=ms, plain_ms=plain_ms, at=at,
                         **bound(10.0 * t.numel(), nbytes(t, d, t, d), dtype))
                with torch.no_grad():
                    yardsticks["add+F.layer_norm_ms"] = time_ms(lambda: F.layer_norm(
                        t + d, (shape[-1],), norm.weight.to(dtype), norm.bias.to(dtype)), reps=20)
                yardsticks["add+F.layer_norm_at"] = at
            del t, d, got, ref
            torch.cuda.empty_cache()

    # the GroupNorm Function (K10 both ways) against autograd of the plain GroupNorm
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((1, FRAMES, LATENT, LATENT, 320), generator=gen, device=device) * 2
             + 0.5).to(dtype)
        dy = torch.randn(x.shape, generator=gen, device=device).to(dtype)
        p = nn.GroupNorm(32, 320, device=device)
        with torch.no_grad():
            p.weight.normal_(1.0, 0.3, generator=gen)
            p.bias.normal_(0.0, 0.2, generator=gen)
        grads = {}
        for on in (True, False):
            with norm_knobs(on):
                xi = x.detach().requires_grad_()
                p.zero_grad()
                y = group_norm(p, xi, 32, 1e-5)
                y.backward(dy)
                grads[on] = (y.detach(), xi.grad, p.weight.grad.clone(), p.bias.grad.clone())
        torch.testing.assert_close(grads[True][0].float(), grads[False][0].float(),
                                   **(dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
                                      else tolerance(dtype)))
        err = grad_error(grads[True][1:], grads[False][1:], dtype)
        log(f"[norm] GroupNorm Function {str(dtype)[6:]} [1, {FRAMES}, {LATENT}, {LATENT}, 320]: "
            f"dx, dscale, dbias vs plain autograd max_abs_err={err:.3e}")
        del x, dy, grads
        torch.cuda.empty_cache()
    log(f"[norm] yardsticks {json.dumps(yardsticks)}")
    return results, yardsticks


def train_step(stage: str, state, cn, config, cn_config, lat, enc, skel, generator, **kw):
    """One train step of ``stage`` through the training modules' entry."""
    from motioneditor_tpu_torch.training import stage1, stage2

    if stage == "stage1":
        return stage1.train_step_stage1(state, lat, enc, generator, config, **kw)
    return stage2.train_step_stage2(state, cn, lat, skel, enc, generator, config, cn_config, **kw)


def phase_train_check(device):
    """A tiny fp32 stage-1 step and stage-2 step, the kernel path (flash on,
    both knobs on) against the plain path (flash off, both knobs off), on
    the same noise (one seed): loss, the trainables' gradients and the
    parameters after one step (Adam eps 1e-4, as tests/test_torch_training.py
    takes it, so that the parameters' agreement follows from the
    gradients')."""
    import copy

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 21)
    cn.requires_grad_(False)
    f, hw = 3, 32  # level-0 attention at N = 1024 reaches every gate
    lat = 0.5 * torch.randn((1, f, hw, hw, 4), generator=gen, device=device)
    enc = 0.5 * torch.randn((1, 7, 16), generator=gen, device=device)
    skel = torch.rand((1, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    t = torch.tensor([437], device=device)
    launched = {}
    for stage, modules in (("stage1", stage1.TRAINABLE_MODULES),
                           ("stage2", stage2.TRAINABLE_MODULES)):
        out = {}
        for kernels in (True, False):
            state = make_train_state(copy.deepcopy(unet), modules,
                                     make_optimizer(learning_rate=1e-3, eps=1e-4))
            with norm_knobs(kernels):
                _build.reset_launch_counts()
                with torch.no_grad():  # the forward alone, for K10's backward count
                    if stage == "stage1":
                        stage1.stage1_loss(state.model, config, lat, enc, lat, t,
                                           use_flash=kernels, remat=False)
                    else:
                        stage2.stage2_loss(state.model, cn, config, cn_config, lat, skel, enc,
                                           lat, t, use_flash=kernels, remat=False)
                fwd_pair_stats = _build.launch_counts["channel_pair_stats"]
                _build.reset_launch_counts()
                gen_step = torch.Generator(device=device).manual_seed(SEED + 22)
                state, metrics = train_step(stage, state, cn, config, cn_config, lat, enc, skel,
                                            gen_step, remat=False, use_flash=kernels)
                torch.cuda.synchronize()
                counts = dict(_build.launch_counts)
            out[kernels] = (float(metrics["loss"]),
                            {n: p.grad.clone() for n, p in state.trainable.items()},
                            {n: p.detach().clone() for n, p in state.trainable.items()})
            if kernels:
                launched[stage] = counts
                if counts.get("channel_pair_stats", 0) <= fwd_pair_stats:
                    raise AssertionError(f"{stage}: K10's backward never launched: {counts}")
            elif counts:
                raise AssertionError(f"{stage}: the plain path launched kernels: {counts}")
        (lk, gk, pk), (lp, gp, pp) = out[True], out[False]
        top = max(g.abs().max().item() for g in gp.values())
        gerr = max((gk[n] - gp[n]).abs().max().item() for n in gp) / top
        perr = max((pk[n] - pp[n]).abs().max().item() for n in pp)
        log(f"[train-check] {stage} tiny fp32 step, kernel vs plain path: loss {lk:.7f} vs "
            f"{lp:.7f}, grad max err {gerr:.3e} of max |g|, param max err {perr:.3e}; "
            f"launches {launched[stage]}")
        if abs(lk - lp) > 1e-5 * abs(lp) or gerr > 1e-4 or perr > 1e-6:
            raise AssertionError(f"{stage}: the kernel path disagrees with the plain path")
    needed = ("video_flash_attention", "temporal_flash_attention") + BACKWARD_KERNELS + NORM_KERNELS
    together = add_counts(*launched.values())
    if not all(together.get(k) for k in needed):
        raise AssertionError(f"the tiny training steps skipped a kernel: {together}")
    return together


def phase_train(device):
    """Stage 1 then stage 2 at full width, bf16 frozen weights with fp32
    masters, gradient checkpointing: both knobs on, then off."""
    import math

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    lat = 0.18215 * torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device)
    enc = torch.randn((1, 77, 768), generator=gen, device=device)
    skel = torch.rand((1, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen, device=device)
    with torch.device(device):
        cn = ControlNetModel(cn_config)
    init_params(cn, gen)
    cn.to(dtype).requires_grad_(False)
    metrics, paths = {}, {}
    for stage, modules, expected in (
            ("stage1", stage1.TRAINABLE_MODULES, EXPECTED_PER_STAGE1_STEP),
            ("stage2", stage2.TRAINABLE_MODULES, EXPECTED_PER_STAGE2_STEP)):
        for on in (True, False):
            key = "on" if on else "off"
            with torch.device(device):
                unet = UNet3DConditionModel(config)
            init_params(unet, torch.Generator(device=device).manual_seed(SEED + 31))
            state = make_train_state(unet, modules, make_optimizer(3e-5), frozen_dtype=dtype)
            before = {n: p.detach().clone() for n, p in unet.named_parameters()}

            def step(i):
                g = torch.Generator(device=device).manual_seed(SEED + 40 + i)
                return train_step(stage, state, cn, config, cn_config, lat, enc, skel, g,
                                  remat=True, compute_dtype=dtype)[1]["loss"]

            with norm_knobs(on):
                step(0)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                losses = [step(i + 1) for i in range(TRAIN_STEPS)]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
                launches = dict(_build.launch_counts)
            losses = [float(x) for x in losses]
            peak = torch.cuda.max_memory_allocated() / 2**30
            metrics[f"{stage}_ms_per_step_knobs_{key}"] = ms
            metrics[f"{stage}_peak_gib_knobs_{key}"] = peak
            log(f"[train] {stage} knobs {key}: {TRAIN_STEPS} steps, {ms:.1f} ms/step, peak "
                f"{peak:.2f} GiB, losses {losses}, launches {launches}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{stage}: losses are not finite: {losses}")
            moved = {n for n, p in unet.named_parameters() if not torch.equal(p, before[n])}
            if not moved or not moved <= set(state.trainable):
                raise AssertionError(f"{stage}: frozen parameters moved: "
                                     f"{sorted(moved - set(state.trainable))[:5]}")
            want = expected if on else {k: v for k, v in expected.items()
                                        if k not in NORM_KERNELS}
            expect_counts(f"{stage} knobs {key}", launches, want, TRAIN_STEPS)
            if on:
                paths[stage] = launches
            del state, unet, before
            torch.cuda.empty_cache()
    del cn
    torch.cuda.empty_cache()
    return paths, metrics


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
    t0 = time.perf_counter()
    norm_results, yardsticks = phase_norm_kernels(device)
    results.update(norm_results)
    log(f"[norm] done in {time.perf_counter() - t0:.1f} s")
    launches, ms_per_step = phase_slice(device)
    phase_check(device)
    phase_null_check(device)
    paths, null_metrics = phase_null_text(device)
    paths["denoise"] = launches
    unet, cn, pipe_paths, pipe_metrics = phase_pipeline(device)
    paths.update(pipe_paths)
    paths["auto"], auto_ms = phase_auto(device, unet, cn)
    del unet, cn
    torch.cuda.empty_cache()
    paths["split_head"] = phase_split_check(device)
    t0 = time.perf_counter()
    paths["train_check"] = phase_train_check(device)
    log(f"[train-check] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_paths, train_metrics = phase_train(device)
    paths.update(train_paths)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        launched = sum(p.get(name, 0) for p in paths.values())
        if not launched:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "at": r["at"],
            "library_at": r.get("library_at"), "flops": r["flops"], "bytes": r["bytes"],
        })
    print(json.dumps({"kernels": kernels, "slice_ms_per_step": ms_per_step, **null_metrics,
                      "auto_ms_per_step": auto_ms, "pipeline": pipe_metrics,
                      "train": train_metrics, "norm_yardsticks": yardsticks,
                      "launches_by_path": paths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
